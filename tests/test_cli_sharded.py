"""CLI-level index-sharding tests (VERDICT round-1 item 1).

`ngm-tpu map --index-shards N` must be record-identical to the unsharded
run, through BOTH execution modes:
- sequential shard loop (one device — how a >int32 genome fits one chip),
- ("dp", "ish") mesh (device count divisible by the shard count).

Multi-chromosome genome so the uint32 global positions returned by the
sharded merge exercise abs->chrom conversion.
"""

import numpy as np
import pytest

from nextgenmap_tpu.cli import main
from nextgenmap_tpu.io.encode import decode_seq
from nextgenmap_tpu.io.fasta import write_fasta
from nextgenmap_tpu.io.simulate import (
    random_genome, simulate_pairs, simulate_reads, write_fastq,
)

N_READS = 96


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_shard")
    rng = np.random.default_rng(31)
    g1 = random_genome(40_000, seed=31)
    g2 = random_genome(25_000, seed=32)
    write_fasta(str(d / "ref.fa"), [("chr1", decode_seq(g1)),
                                    ("chr2", decode_seq(g2))])
    # simulate from the concatenated space of each chromosome separately
    reads = simulate_reads(g1, N_READS // 2, read_len=100, snp_rate=0.03,
                           indel_rate=0.003, seed=33)
    reads += simulate_reads(g2, N_READS // 2, read_len=100, snp_rate=0.03,
                            indel_rate=0.003, seed=34, prefix="c2")
    write_fastq(str(d / "reads.fq"), reads)
    pairs = simulate_pairs(g1, N_READS // 2, read_len=100, insert_mean=300,
                           insert_sd=30, snp_rate=0.02, seed=35)
    write_fastq(str(d / "r1.fq"), [p[0] for p in pairs])
    write_fastq(str(d / "r2.fq"), [p[1] for p in pairs])
    return d


def run_map(d, out, extra=()):
    rc = main([
        "map", "-r", str(d / "ref.fa"), "-q", str(d / "reads.fq"),
        "-o", str(d / out), "-k", "11", "--batch-size", "32", "--no-progress",
        *extra,
    ])
    assert rc == 0
    return [l for l in (d / out).read_text().splitlines()
            if not l.startswith("@PG")]


def run_map_paired(d, out, extra=()):
    rc = main([
        "map", "-r", str(d / "ref.fa"), "-1", str(d / "r1.fq"),
        "-2", str(d / "r2.fq"),
        "-o", str(d / out), "-k", "11", "--batch-size", "32", "--no-progress",
        *extra,
    ])
    assert rc == 0
    return [l for l in (d / out).read_text().splitlines()
            if not l.startswith("@PG")]


def test_sequential_shards_identical(shard_dir):
    base = run_map(shard_dir, "base.sam")
    assert sum(1 for l in base if not l.startswith("@")) == N_READS
    seq2 = run_map(shard_dir, "seq2.sam", ("--index-shards", "2"))
    assert base == seq2
    seq3 = run_map(shard_dir, "seq3.sam", ("--index-shards", "3"))
    assert base == seq3


def test_sharded_megabatch_identical(shard_dir):
    """--megabatch K x --index-shards S (map_step_sharded_megascan): one
    dispatch per K batches through the fused shard loop; must be
    record-identical to the per-batch sharded run, including the PADDED tail
    group (96 reads / 32 = 3 batches with K=2 -> one full + one padded)."""
    base = run_map(shard_dir, "mb_base.sam", ("--index-shards", "2"))
    mb = run_map(shard_dir, "mb2.sam", ("--index-shards", "2",
                                        "--megabatch", "2"))
    assert base == mb
    pbase = run_map_paired(shard_dir, "mb_pbase.sam", ("--index-shards", "2"))
    pmb = run_map_paired(shard_dir, "mb_p2.sam",
                         ("--index-shards", "2", "--megabatch", "2"))
    assert pbase == pmb


def test_megabatch_pool_emitter_identical(shard_dir):
    """--megabatch K with -t 4 engages the GROUP-parallel render pool
    (runner.py group_wrap): whole groups render in pool workers, the ordered
    committer writes — bytes must equal the serial megabatch run, SE and
    PE."""
    base = run_map(shard_dir, "mp_base.sam", ("--megabatch", "2"))
    pool = run_map(shard_dir, "mp_pool.sam", ("--megabatch", "2", "-t", "4"))
    assert base == pool
    pbase = run_map_paired(shard_dir, "mp_pbase.sam", ("--megabatch", "2"))
    ppool = run_map_paired(shard_dir, "mp_ppool.sam",
                           ("--megabatch", "2", "-t", "4"))
    assert pbase == ppool


def test_mesh_shards_identical(shard_dir):
    base = run_map(shard_dir, "base2.sam")
    mesh = run_map(shard_dir, "mesh4.sam",
                   ("--index-shards", "4", "--devices", "8"))
    assert base == mesh


def test_paired_shards_identical(shard_dir):
    base = run_map_paired(shard_dir, "pbase.sam")
    # proper pairs must exist for the pair-consistent merge to be exercised
    proper = sum(1 for l in base
                 if not l.startswith("@") and int(l.split("\t")[1]) & 2)
    assert proper >= int(0.9 * N_READS)
    seq = run_map_paired(shard_dir, "pseq.sam", ("--index-shards", "2"))
    assert base == seq
    mesh = run_map_paired(shard_dir, "pmesh.sam",
                          ("--index-shards", "2", "--devices", "4"))
    assert base == mesh


def test_kmer_min_shard_invariant(shard_dir):
    """--kmer-min's zero-CMR retry must gate on the CROSS-shard best bucket
    count (ADVICE round-2): a shard-local retry could emit candidates the
    unsharded run never generates."""
    base = run_map(shard_dir, "km_base.sam", ("--kmer-min", "3"))
    seq = run_map(shard_dir, "km_seq.sam", ("--kmer-min", "3",
                                            "--index-shards", "3"))
    assert base == seq
    mesh = run_map(shard_dir, "km_mesh.sam",
                   ("--kmer-min", "3", "--index-shards", "2", "--devices", "4"))
    assert base == mesh


def test_rejected_combos(shard_dir):
    from nextgenmap_tpu.config import NgmConfig

    with pytest.raises(ValueError):
        # topn x shards runs only on the sequential one-device shard loop
        NgmConfig(index_shards=2, topn=3, devices=4).validate()
    # bs x shards and topn x shards are supported since round 3
    NgmConfig(index_shards=2, bs_mapping=True).validate()
    NgmConfig(index_shards=2, topn=3).validate()


def test_dist_plus_index_shards(shard_dir, tmp_path):
    """BASELINE config 4 composition: reads round-robin across hosts (dist),
    index position-sharded over each host's LOCAL devices (ish) — per-shard
    merges ride ICI only, cross-host traffic is just read/output sharding.
    Two real processes, each on a (dp=2, ish=2) local mesh."""
    import os
    import subprocess
    import sys

    d = shard_dir
    REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = run_map(d, "dist_base.sam")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = tmp_path / "dist_ish.sam"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "nextgenmap_tpu.cli", "map",
             "-r", str(d / "ref.fa"), "-q", str(d / "reads.fq"),
             "-o", str(out), "-k", "11", "--batch-size", "32",
             "--no-progress", "--index-shards", "2", "--devices", "4",
             "--dist-nprocs", "2", "--dist-procid", str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=900)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    got = [l for l in out.read_text().splitlines() if not l.startswith("@PG")]
    assert got == base


def test_index_verb_prebuilds_shards(shard_dir, tmp_path):
    """`ngm-tpu index --index-shards N` pre-builds BOTH artifacts (raw CSR +
    .ngmt-shards) so the later map run does zero index work (VERDICT
    round-2 directive 9)."""
    import glob
    import os
    import shutil

    d = tmp_path
    for f in ("ref.fa", "reads.fq"):
        shutil.copy(shard_dir / f, d / f)
    rc = main(["index", "-r", str(d / "ref.fa"), "-k", "11",
               "--index-shards", "2"])
    assert rc == 0
    shard_caches = glob.glob(str(d / "ref.fa.ngmt-shards-*"))
    ht_caches = glob.glob(str(d / "ref.fa.ngmt-ht-*"))
    assert len(shard_caches) == 1 and len(ht_caches) == 1
    # the encoded-genome artifact is created by the index verb too
    mtimes = {p: os.path.getmtime(p)
              for p in glob.glob(str(d / "ref.fa.ngmt-*"))}
    rc = main([
        "map", "-r", str(d / "ref.fa"), "-q", str(d / "reads.fq"),
        "-o", str(d / "out.sam"), "-k", "11", "--batch-size", "32",
        "--no-progress", "--index-shards", "2",
    ])
    assert rc == 0
    # zero index work: no new artifacts, nothing rebuilt
    assert sorted(glob.glob(str(d / "ref.fa.ngmt-*"))) == sorted(mtimes)
    for p, t in mtimes.items():
        assert os.path.getmtime(p) == t, f"{p} was rebuilt"
    n_recs = sum(1 for l in (d / "out.sam").read_text().splitlines()
                 if not l.startswith("@"))
    assert n_recs == N_READS


def test_sharded_index_memoization(shard_dir, tmp_path):
    """The per-shard artifact is memoized and reloaded; output unchanged."""
    import shutil

    d = tmp_path
    for f in ("ref.fa", "reads.fq"):
        shutil.copy(shard_dir / f, d / f)
    run = lambda out, extra=(): main([
        "map", "-r", str(d / "ref.fa"), "-q", str(d / "reads.fq"),
        "-o", str(d / out), "-k", "11", "--batch-size", "32", "--no-progress",
        "--index-shards", "2", *extra,
    ])
    assert run("a.sam") == 0
    import glob

    caches = glob.glob(str(d / "ref.fa.ngmt-shards-*"))
    assert len(caches) == 1, caches
    assert run("b.sam") == 0  # second run loads the artifact
    strip = lambda p: [l for l in open(d / p) if not l.startswith("@PG")]
    assert strip("a.sam") == strip("b.sam")
    # a different repeat-mask cap changes the shard CSR bytes — it must NOT
    # reuse the artifact (ADVICE round-2: stale-masking bug)
    assert run("c.sam", ("--max-freq", "7")) == 0
    caches = glob.glob(str(d / "ref.fa.ngmt-shards-*"))
    assert len(caches) == 2, caches


def test_sharded_scan_compile_failure_falls_back(monkeypatch):
    """A device error from the fused sharded-scan program propagates: the
    Mapper does not switch to the host-driven shard loop behind the user's
    back (on a GPU an out-of-memory error is the same exception type, so a
    catch would turn a failure into a silently different program).  The
    host loop stays reachable explicitly (NGM_SHARD_LOOP=host) and is
    bit-identical to the scan.  The name is kept from the test of the
    fallback this replaced, so the test's history stays one line."""
    import jax
    import numpy as np

    from nextgenmap_tpu import models
    from nextgenmap_tpu.config import NgmConfig
    from nextgenmap_tpu.index.kmer_index import KmerIndex
    from nextgenmap_tpu.io.simulate import random_genome, simulate_reads
    from nextgenmap_tpu.models.mapper import Mapper

    cfg = NgmConfig(kmer=11, index_shards=2, skip_save=True, devices=1)
    g = random_genome(40_000, seed=5)
    idx = KmerIndex.build(g, k=11, skip=2, max_freq=1000)

    class _G:
        pass

    gobj = _G()
    gobj.codes = g
    mapper = Mapper(cfg, gobj, 100, index=idx)
    reads = simulate_reads(g, 32, read_len=100, snp_rate=0.02, seed=6)
    codes = np.stack([r.codes for r in reads])
    lens = np.full(32, 100, np.int32)
    want = mapper.map_batch(codes, lens)

    fresh = Mapper(cfg, gobj, 100, index=idx)
    calls = {"n": 0}

    def boom(*a, **k):
        calls["n"] += 1
        raise jax.errors.JaxRuntimeError("synthetic device error")

    with monkeypatch.context() as mp:
        mp.setattr(models.mapper, "map_step_sharded_scan", boom)
        for _ in range(2):        # every call reaches the scan and fails
            with pytest.raises(jax.errors.JaxRuntimeError):
                fresh.map_batch(codes, lens)
    assert calls["n"] == 2

    monkeypatch.setenv("NGM_SHARD_LOOP", "host")
    got = fresh.map_batch(codes, lens)
    for f in ("mapped", "pos", "strand", "score", "mapq"):
        assert np.array_equal(np.asarray(getattr(want, f)),
                              np.asarray(getattr(got, f))), f
