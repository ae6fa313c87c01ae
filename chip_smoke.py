#!/usr/bin/env python3
"""Proof that the mapper runs on an NVIDIA GPU.

    python chip_smoke.py           # one card: phases 0-3
    python chip_smoke.py --multi   # four cards: the mesh paths vs one card

Phases (one card):
  0  environment: the card's name and power limit (nvidia-smi), the JAX
     version and devices, native IO, the compile cache.  Anything but a GPU
     is refused.
  1  tests/test_gpu.py on the card: SW score/align vs the scalar oracle,
     k-mer and row-fetch matmuls vs their plain forms; all exact.
  2  first XLA timings of the step's kernels: median of 7 runs after a
     warm-up, next to the card's name.  A starting point, not a benchmark.
  3  the main path through `ngm-tpu map` (cli.main) on a seeded 64 Mbp
     genome (chr20 scale, BASELINE.json configs 2-3), reads at 2% SNPs and
     0.2% indels: (a) SE 150 bp, (b) PE 2x150, (c) SE 1000 bp, (d) the reads
     of (a) with --index-shards 2, whose SAM body must equal (a)'s.  Each
     case needs >= 95% of reads (of mates) within 5 bp of truth on the
     right strand.

--multi runs phase 0 and then only the four-card check: the PE set of (b)
with --devices 1, 4; --index-shards 4 --devices 4; --index-shards 2
--devices 4.  Every SAM body must equal the one-card run's, and the index
tables must be spread over the mesh devices.

One process drives the card(s).  The last line of stdout is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
printed only when every phase passed; otherwise the exit code is 1.  Work
files go to .smoke_work/ at the checkout root and are removed at the end.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")
SNP_RATE = 0.02
INDEL_RATE = 0.002
MIN_CORRECT = 0.95
TRUTH_SLACK = 5        # bp between SAM POS and the simulated position


@dataclass(frozen=True)
class Sizes:
    genome: int = 64_000_000     # chr20 scale
    se_reads: int = 32_768       # (a), (d)
    pe_pairs: int = 16_384       # (b), --multi
    long_reads: int = 2_048      # (c)
    sw_short: int = 16_384       # phase 2 slot counts
    sw_long: int = 2_048
    take_rows: int = 8_192       # [2B, L] score-pass query table (B = 4096)
    kmer_batch: int = 4_096


class PhaseFailed(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


class Ctx:
    """What the phases share: the card label, sizes and the seed."""

    def __init__(self, sizes: Sizes, seed: int, multi: bool):
        self.sizes, self.seed = sizes, seed
        self.card = "unknown card"
        self.n_cards = 4 if multi else 1


# ---------------------------------------------------------------- phase 0
def card_lines() -> list[str]:
    """nvidia-smi's name and power limit per card (no JAX in this process)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise PhaseFailed(f"no GPU: nvidia-smi did not run ({e})")
    lines = [l.strip() for l in out.stdout.splitlines() if l.strip()]
    check(out.returncode == 0 and bool(lines),
          f"no GPU: nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return lines


def phase_environment(ctx: Ctx) -> None:
    problems = []
    try:
        cards = card_lines()
        for line in cards:
            log(f"card: {line}")
        ctx.card = cards[0]
    except PhaseFailed as e:
        problems.append(str(e))
    try:
        import nextgenmap_tpu
    except ImportError as e:
        raise PhaseFailed(
            f"nextgenmap_tpu is not importable ({e}): run chip_smoke.py "
            "from the root of a checkout"
        )
    pkg = os.path.dirname(os.path.abspath(nextgenmap_tpu.__file__))
    check(pkg == os.path.join(REPO, "nextgenmap_tpu"),
          f"nextgenmap_tpu imported from {pkg}, not from this checkout")
    from nextgenmap_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    log(f"jax {jax.__version__}")
    try:
        devs = jax.devices()
    except RuntimeError as e:
        raise PhaseFailed(f"no GPU: JAX could not start a backend ({e})")
    log(f"jax devices: {devs}")
    if devs[0].platform != "gpu":
        problems.append(f"no GPU: JAX found platform {devs[0].platform!r}")
    elif len(devs) < ctx.n_cards:
        problems.append(f"--multi needs {ctx.n_cards} GPUs, JAX found "
                        f"{len(devs)}")
    from nextgenmap_tpu import native

    log(f"native IO: {'loaded' if native.lib() is not None else 'Python'}")
    log("compile cache: "
        f"{jax.config.jax_compilation_cache_dir or 'none'}")
    check(not problems, "; ".join(problems))


# ---------------------------------------------------------------- phase 1
class _Outcomes:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1
        elif report.when == "call":
            self.passed += 1


def phase_gpu_tests(ctx: Ctx) -> None:
    import pytest

    env = dict(os.environ)
    seen = _Outcomes()
    try:
        rc = pytest.main(
            [os.path.join(REPO, "tests", "test_gpu.py"), "-q", "-m", "gpu",
             "-p", "no:cacheprovider", "-rfs"],
            plugins=[seen],
        )
    finally:               # the test bootstrap sets env defaults; undo them
        os.environ.clear()
        os.environ.update(env)
    log(f"gpu tests: exit {int(rc)}, passed {seen.passed}, failed "
        f"{seen.failed}, skipped {seen.skipped}")
    check(rc == 0 and seen.passed > 0 and not seen.failed
          and not seen.skipped, "gpu tests did not all pass on the card")


# ---------------------------------------------------------------- phase 2
def median_ms(fn, *args, runs: int = 7) -> float:
    import jax

    jax.block_until_ready(fn(*args))          # compile + warm-up
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def phase_xla_timings(ctx: Ctx) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import nextgenmap_tpu.ops.kmer as km
    from nextgenmap_tpu.config import NgmConfig
    from nextgenmap_tpu.io.simulate import simulate_corridors
    from nextgenmap_tpu.ops.gather import gather_windows, pad_table, take_rows_mxu
    from nextgenmap_tpu.ops.scoring import score_matrix
    from nextgenmap_tpu.ops.sw_ref import banded_sw_align, banded_sw_score

    sz, cfg = ctx.sizes, NgmConfig()
    rng = np.random.default_rng(ctx.seed)
    tag = f"[{ctx.card}]"
    mats = jnp.asarray(np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)]))
    gaps = (jnp.int32(20), jnp.int32(20), jnp.int32(20))
    genome = jax.device_put(
        rng.integers(0, 4, sz.genome, dtype=np.int64).astype(np.uint8))
    for n, L in ((sz.sw_short, 150), (sz.sw_long, 1000)):
        W = cfg.corridor_for(L)
        T = L + W
        q, r = simulate_corridors(n, L, W, SNP_RATE, INDEL_RATE, ctx.seed)
        args = (jnp.asarray(q), jnp.full(n, L, jnp.int32), jnp.asarray(r),
                mats, *gaps, jnp.arange(n, dtype=jnp.int32) % 2)
        cells = n * L * W
        for name, fn in (("score", banded_sw_score), ("align", banded_sw_align)):
            ms = median_ms(lambda *a: fn(*a, band=W, simple=True), *args)
            log(f"xla {tag} banded_sw_{name} [{n},{L}]xW{W}: {ms:.3f} ms, "
                f"{cells / ms / 1e6:.2f} GCUPS")
        starts = jnp.asarray(rng.integers(0, sz.genome - T, n, dtype=np.int32))
        padded = pad_table(genome, T, 4)
        ms_step = median_ms(
            jax.jit(lambda g, s: gather_windows(pad_table(g, T, 4), s, T)),
            genome, starts)
        ms_gather = median_ms(
            jax.jit(lambda g, s: gather_windows(g, s, T)), padded, starts)
        log(f"xla {tag} gather_windows {n} x {T} B from {sz.genome} B: "
            f"{ms_gather:.3f} ms ({ms_gather * 1e3 / n:.4f} us/window); "
            f"with the step's pad_table copy: {ms_step:.3f} ms")

    stack = jnp.asarray(rng.integers(0, 5, (sz.take_rows, 150)).astype(np.uint8))
    rows = jnp.asarray(rng.integers(0, sz.take_rows, sz.take_rows // 4,
                                    dtype=np.int32))
    ms_mm = median_ms(jax.jit(take_rows_mxu), stack, rows)
    ms_take = median_ms(jax.jit(lambda s, i: jnp.take(s, i, axis=0)),
                        stack, rows)
    log(f"xla {tag} rows {rows.shape[0]} of [{sz.take_rows},150]: "
        f"take_rows_mxu {ms_mm:.3f} ms, jnp.take {ms_take:.3f} ms")

    codes = jnp.asarray(
        rng.integers(0, 5, (sz.kmer_batch, 150)).astype(np.uint8))
    lens = jnp.full(sz.kmer_batch, 150, jnp.int32)
    fn = km.extract_kmers_canonical.__wrapped__
    res, default = {}, km._KMER_BACKEND
    try:
        for backend in ("mxu", "slice"):
            km._KMER_BACKEND = backend   # read at trace time: fresh jit each
            res[backend] = median_ms(
                jax.jit(lambda c, l: fn(c, l, cfg.kmer, cfg.read_kmer_skip)),
                codes, lens)
    finally:
        km._KMER_BACKEND = default
    log(f"xla {tag} extract_kmers_canonical [{sz.kmer_batch},150] "
        f"k={cfg.kmer} stride {cfg.read_kmer_skip}: banded matmul "
        f"{res['mxu']:.3f} ms, slice {res['slice']:.3f} ms")


# ---------------------------------------------------------------- phase 3
def write_inputs(ctx: Ctx, which: tuple[str, ...]) -> dict:
    """Seeded genome + read files in WORK; names carry the truth."""
    import dataclasses

    from nextgenmap_tpu.io.encode import decode_seq
    from nextgenmap_tpu.io.fasta import write_fasta
    from nextgenmap_tpu.io.simulate import (
        random_genome, simulate_pairs, simulate_reads, write_fastq,
    )

    sz, seed = ctx.sizes, ctx.seed
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t0 = time.time()
    g = random_genome(sz.genome, seed=seed)
    paths = {"ref": os.path.join(WORK, "ref.fa")}
    write_fasta(paths["ref"], [("chr20", decode_seq(g))])
    if "se" in which:      # simread_<i>_<pos>_<strand>
        paths["se"] = os.path.join(WORK, "se150.fq")
        write_fastq(paths["se"], simulate_reads(
            g, sz.se_reads, 150, SNP_RATE, INDEL_RATE, seed=seed + 1))
    if "pe" in which:      # simpair_<i>_<pos1>_<pos2>: mate 1 fwd, mate 2 rev
        pairs = simulate_pairs(g, sz.pe_pairs, 150, snp_rate=SNP_RATE,
                               indel_rate=INDEL_RATE, seed=seed + 2)
        for m in (0, 1):
            paths[f"pe{m + 1}"] = os.path.join(WORK, f"pe_{m + 1}.fq")
            write_fastq(paths[f"pe{m + 1}"], [
                dataclasses.replace(p[m], name=f"simpair_{i}_{p[0].pos}_{p[1].pos}")
                for i, p in enumerate(pairs)
            ])
    if "long" in which:
        paths["long"] = os.path.join(WORK, "se1000.fq")
        write_fastq(paths["long"], simulate_reads(
            g, sz.long_reads, 1000, SNP_RATE, INDEL_RATE, seed=seed + 3))
    log(f"inputs: {sz.genome} bp genome and reads {sorted(which)} written in "
        f"{time.time() - t0:.1f} s")
    return paths


def truth_counts(sam_path: str, paired: bool) -> tuple[int, int, int]:
    """(records, mapped, truth-correct) over primary records."""
    total = mapped = correct = 0
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            name, flag, _, pos = line.split("\t", 4)[:4]
            flag, pos = int(flag), int(pos)
            if flag & 0x900:
                continue
            total += 1
            if flag & 0x4:
                continue
            mapped += 1
            parts = name.split("_")
            if paired:
                mate2 = bool(flag & 0x80)
                tpos, tstrand = int(parts[3 if mate2 else 2]), int(mate2)
            else:
                tpos, tstrand = int(parts[2]), int(parts[3])
            if (abs(pos - 1 - tpos) <= TRUTH_SLACK
                    and int(bool(flag & 0x10)) == tstrand):
                correct += 1
    return total, mapped, correct


def sam_body(path: str) -> list[str]:
    """Every line but @PG (which holds the command line)."""
    with open(path) as f:
        return [l for l in f if not l.startswith("@PG")]


def run_case(ctx: Ctx, tag: str, paths: dict, reads: tuple[str, ...],
             extra: tuple[str, ...] = (), on_mapper=None) -> dict:
    """One `ngm-tpu map` through cli.main; returns its numbers."""
    import jax

    import nextgenmap_tpu.pipeline.runner as runner
    from nextgenmap_tpu.cli import main

    out = os.path.join(WORK, tag.replace(" ", "_") + ".sam")
    paired = len(reads) == 2
    argv = ["map", "-r", paths["ref"], "-o", out, "--no-progress", *extra]
    argv += (["-1", paths[reads[0]], "-2", paths[reads[1]]] if paired
             else ["-q", paths[reads[0]]])
    got = {}
    run_mapping, mapper_cls = runner.run_mapping, runner.Mapper
    devs = jax.local_devices()[: ctx.n_cards]

    def in_use(key: str = "bytes_in_use") -> list[int]:
        return [(d.memory_stats() or {}).get(key, 0) for d in devs]

    def spy(*a, **k):
        got["stats"] = run_mapping(*a, **k)
        return got["stats"]

    class SpyMapper(mapper_cls):
        def __post_init__(self):
            super().__post_init__()
            got["obj"] = self        # keep its tables alive past the run
            if on_mapper is not None:
                got["mapper"] = on_mapper(self)

    gc.collect()                     # drop the previous case's tables
    before = in_use()
    runner.run_mapping, runner.Mapper = spy, SpyMapper
    t0 = time.time()
    try:
        rc = main(argv)
    finally:
        runner.run_mapping, runner.Mapper = run_mapping, mapper_cls
    t1 = time.time()
    st = got["stats"]
    total, mapped, correct = truth_counts(out, paired)
    # bytes the Mapper holds per card at the end of the run (its tables,
    # including those a sharded Mapper places lazily); the peak is the
    # process's since it started (it cannot be reset between cases)
    gc.collect()
    mapper = got.pop("obj")
    jax.block_until_ready(list(vars(mapper).values()))
    held = [b - a for a, b in zip(before, in_use())]
    del mapper
    peak = in_use("peak_bytes_in_use")
    r = dict(
        tag=tag, exit=rc, records=total, mapped=mapped, truth_correct=correct,
        reads_per_s=(st.reads_in - st.first_batch_reads)
        / max(1e-9, t1 - st.first_batch_time),
        wall_s=t1 - t0, first_batch_s=st.first_batch_time - t0,
        table_bytes=held, sam=out, placement=got.get("mapper"),
    )
    log(f"map {tag} [{ctx.card}]: exit {rc}, records {total}, mapped "
        f"{mapped}, truth-correct {correct} ({100.0 * correct / max(1, total):.2f}%), "
        f"streaming {r['reads_per_s']:.1f} reads/s, wall {r['wall_s']:.1f} s, "
        f"first batch at {r['first_batch_s']:.1f} s, device bytes held by "
        f"the Mapper after the run {held}, process peak device bytes {peak}")
    check(rc == 0, f"{tag}: ngm-tpu map exited {rc}")
    check(correct >= MIN_CORRECT * total and total > 0,
          f"{tag}: {correct}/{total} truth-correct < {MIN_CORRECT:.0%}")
    return r


def same_body(a: dict, b: dict) -> None:
    ba, bb = sam_body(a["sam"]), sam_body(b["sam"])
    diff = next((i for i, (x, y) in enumerate(zip(ba, bb)) if x != y), None)
    same = diff is None and len(ba) == len(bb)
    log(f"SAM body of {b['tag']} == {a['tag']}: {same}"
        + ("" if same else f" (first difference at line {diff})"))
    check(same, f"{b['tag']} SAM body differs from {a['tag']}")


def phase_main_path(ctx: Ctx) -> None:
    sz = ctx.sizes
    paths = write_inputs(ctx, ("se", "pe", "long"))
    failed = []
    results = {}
    for tag, reads, n, extra in (
        ("a SE 150", ("se",), sz.se_reads, ()),
        ("b PE 2x150", ("pe1", "pe2"), 2 * sz.pe_pairs, ()),
        ("c SE 1000", ("long",), sz.long_reads, ()),
        ("d SE 150 index-shards 2", ("se",), sz.se_reads,
         ("--index-shards", "2")),
    ):
        try:
            results[tag[0]] = r = run_case(ctx, tag, paths, reads, extra)
            check(r["records"] == n, f"{tag}: {r['records']} records, want {n}")
            if tag[0] == "d":
                same_body(results["a"], r)
        except Exception as e:            # run the other cases, then fail
            traceback.print_exc()
            failed.append(f"{tag}: {e}")
    check(not failed, "; ".join(failed))


# ----------------------------------------------------------- --multi phase
def placement(mapper) -> str:
    """Where the mesh Mapper's positions table lives, per device."""
    if getattr(mapper, "_ish_args", None) is not None and mapper._shard_args is None:
        arr = mapper._ish_args[2]
        rows = {sh.device.id: sh.index[0].start for sh in arr.addressable_shards}
        S = arr.shape[0]
        spread = (len(rows) == mapper.n_devices
                  and sorted(set(rows.values())) == list(range(S))
                  and all(sh.data.shape[0] == 1 for sh in arr.addressable_shards))
        return f"ish rows by device {rows}: {'spread' if spread else 'NOT spread'}"
    sh = getattr(mapper, "_pos_dev", None)
    if sh is None:
        return "no tables"
    devs = sorted(d.id for d in sh.sharding.device_set)
    ok = len(devs) == mapper.n_devices and sh.sharding.is_fully_replicated
    return f"replicated on devices {devs}: {'spread' if ok else 'NOT spread'}"


def phase_multi(ctx: Ctx) -> None:
    paths = write_inputs(ctx, ("pe",))
    reads = ("pe1", "pe2")
    one = run_case(ctx, "PE 2x150 devices 1", paths, reads, ("--devices", "1"))
    failed = []
    for extra in (("--devices", "4"),
                  ("--index-shards", "4", "--devices", "4"),
                  ("--index-shards", "2", "--devices", "4")):
        tag = "PE 2x150 " + " ".join(extra).replace("--", "")
        try:
            r = run_case(ctx, tag, paths, reads, extra, on_mapper=placement)
            log(f"{tag}: {r['reads_per_s']:.1f} reads/s on 4 cards "
                f"(one card: {one['reads_per_s']:.1f}); placement "
                f"{r['placement']}")
            same_body(one, r)
            check("NOT" not in r["placement"], f"{tag}: tables not spread")
        except Exception as e:
            traceback.print_exc()
            failed.append(f"{tag}: {e}")
    check(not failed, "; ".join(failed))


# -------------------------------------------------------------------- main
def phases(multi: bool) -> list[tuple[str, object]]:
    """(name, function) of the phases a run executes, in order."""
    if multi:
        return [("0 environment", phase_environment),
                ("four-card meshes", phase_multi)]
    return [("0 environment", phase_environment),
            ("1 gpu tests", phase_gpu_tests),
            ("2 xla timings", phase_xla_timings),
            ("3 main path", phase_main_path)]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: the --devices/--index-shards meshes "
                         "against one card, and nothing else")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    ctx = Ctx(Sizes(), a.seed, a.multi)
    t_start = time.time()
    failed = []
    try:
        for name, fn in phases(a.multi):
            t0 = time.time()
            log(f"== phase {name}")
            try:
                fn(ctx)
                log(f"== phase {name}: ok ({time.time() - t0:.1f} s)")
            except Exception as e:
                if not isinstance(e, PhaseFailed):
                    traceback.print_exc()
                log(f"== phase {name}: FAILED: {e}")
                failed.append(name)
                if name.startswith("0"):
                    break
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"total {time.time() - t_start:.1f} s")
    if failed:
        print(f"chip_smoke: FAILED: {', '.join(failed)}", file=sys.stderr)
        return 1
    import jax

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
