"""Benchmark: reads/sec of the device step on one GPU, BASELINE.json config 1.

Workload: E. coli-scale synthetic genome (4.6 Mbp) + simulated 100 bp
single-end reads at 2% SNPs, mapped through the jitted device step
(CS -> score -> select -> traceback).  Host SAM formatting is excluded.
Refuses to run on anything but a GPU.

vs_baseline: the reference publishes no machine-readable numbers; the proxy
is 15,000 reads/s, the order of magnitude NextGenMap-era mappers sustained
on a 2013 quad-core CPU for 100 bp SE reads at default sensitivity.

Prints exactly ONE JSON line to stdout; diagnostics go to stderr.
"""

import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from nextgenmap_tpu.config import NgmConfig
from nextgenmap_tpu.io.simulate import random_genome, simulate_reads_fast
from nextgenmap_tpu.models.mapper import map_step
from nextgenmap_tpu.ops.scoring import score_matrix
from nextgenmap_tpu.utils.compile_cache import enable_compile_cache

GENOME_SIZE = 4_600_000   # E. coli K-12 scale
READ_LEN = 100
BATCH = 4096
N_BATCHES = 36            # two-point fit: walls at 12 and 36 batches
SNP_RATE = 0.02
BASELINE_READS_PER_SEC = 15_000.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> None:
    # defaults: k=13; genome indexed at every position (kmer_skip=1) and the
    # READ side strided at 2 (read_kmer_skip) — the inversion of the
    # reference's genome-side --kmer-skip 2 (same hits per locus, half the
    # random index lookups; config.py)
    enable_compile_cache()
    cfg = NgmConfig()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform}")
    log(f"device: {dev.platform} {dev.device_kind}")

    t0 = time.time()
    g = random_genome(GENOME_SIZE, seed=1)
    genome_d = jax.device_put(jnp.asarray(g))
    from nextgenmap_tpu.index.device_build import build_index_device

    off_d, pos_d = build_index_device(
        genome_d, k=cfg.kmer, skip=cfg.kmer_skip, canonical=True
    )
    jax.block_until_ready(pos_d)
    log(f"index built on device in {time.time() - t0:.1f}s ({pos_d.shape[0]} positions)")
    # single-gather packed offsets, as the production Mapper uses
    from nextgenmap_tpu.ops.candidate import pack_offsets

    packed = pack_offsets(off_d, cfg.max_kmer_freq, cfg.max_kmer_fanout)
    packed_offsets = packed is not None
    if packed_offsets:
        off_d = packed

    codes, truth_pos, truth_strand = simulate_reads_fast(
        g, BATCH * N_BATCHES, read_len=READ_LEN, snp_rate=SNP_RATE, seed=2
    )
    lens = np.full(BATCH, READ_LEN, np.int32)
    mats = np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])
    band = cfg.corridor_for(READ_LEN)
    statics = dict(
        k=cfg.kmer, fanout_cap=cfg.max_kmer_fanout,
        hit_cap=cfg.resolved_read_hits(int(pos_d.shape[0]), READ_LEN),
        max_cmrs=cfg.max_cmrs, diag_bin_log2=cfg.diag_bin_log2, band=band,
        min_kmer_hits=1, read_stride=cfg.read_kmer_skip,
        packed_offsets=packed_offsets, canonical=True,
        simple_matrix=True,
    )

    mats_d = jnp.asarray(mats)
    lens_d = jnp.asarray(lens)
    scal = (
        jnp.int32(cfg.gap_read_penalty), jnp.int32(cfg.gap_ref_penalty),
        jnp.int32(cfg.gap_extend_penalty), jnp.float32(cfg.sensitivity),
        jnp.int32(cfg.max_kmer_freq),
        jnp.float32(cfg.min_identity), jnp.float32(cfg.min_residues),
    )

    # lax.scan programs over stacked batches with per-batch counters
    # computed in-program (including the truth check), timed to the fetch
    # of those counters; the metric is the MARGINAL per-batch time from a
    # two-point fit (N1 and N2 batches), which drops the fixed per-program
    # cost.
    truth_pos_d = jnp.asarray(truth_pos.reshape(N_BATCHES, BATCH))
    truth_strand_d = jnp.asarray(truth_strand.reshape(N_BATCHES, BATCH))

    def make_scan():
        @jax.jit
        def run_scan(genome, off, pos, stk, tp, ts):
            def body(c, xs):
                batch_codes, tpb, tsb = xs
                r = map_step(
                    genome, off, pos, batch_codes, lens_d, mats_d, *scal,
                    **statics,
                )
                ok = (
                    r.mapped
                    & (jnp.abs(r.pos - tpb) <= 5)
                    & (r.strand == tsb)
                )
                return c, (jnp.sum(r.mapped), jnp.sum(ok),
                           jnp.sum(r.n_candidates))
            return jax.lax.scan(body, 0, (stk, tp, ts))[1]
        return run_scan

    run_scan = make_scan()

    def fetch(x):
        return jax.tree_util.tree_map(np.asarray, x)

    stk_all = jax.device_put(
        jnp.asarray(codes.reshape(N_BATCHES, BATCH, READ_LEN))
    )
    warm_codes, _, _ = simulate_reads_fast(
        g, BATCH * N_BATCHES, read_len=READ_LEN, snp_rate=SNP_RATE, seed=3
    )
    warm = jax.device_put(
        jnp.asarray(warm_codes.reshape(N_BATCHES, BATCH, READ_LEN))
    )
    jax.block_until_ready([stk_all, warm])

    N1 = N_BATCHES // 3
    walls = {}
    outs = {}
    for n in (N1, N_BATCHES):
        args = (genome_d, off_d, pos_d, stk_all[:n], truth_pos_d[:n],
                truth_strand_d[:n])
        t0 = time.time()
        fetch(run_scan(genome_d, off_d, pos_d, warm[:n], truth_pos_d[:n],
                       truth_strand_d[:n]))
        log(f"compile+warm sweep (N={n}): {time.time() - t0:.1f}s")
        t0 = time.time()
        outs[n] = fetch(run_scan(*args))
        walls[n] = time.time() - t0

    t_batch = (walls[N_BATCHES] - walls[N1]) / (N_BATCHES - N1)
    fixed = walls[N1] - N1 * t_batch
    mapped_n, ok_n, cand_n = outs[N_BATCHES]
    mapped, ok, n_cands = int(mapped_n.sum()), int(ok_n.sum()), int(cand_n.sum())
    n_reads = BATCH * N_BATCHES
    rps = BATCH / t_batch

    # DP cells for GCUPS: both strands scored over C candidates is the actual
    # compute; count cells actually executed (score pass over all candidates
    # + traceback pass over the winner)
    cells = (n_cands + n_reads) * READ_LEN * band
    gcups = cells / (t_batch * N_BATCHES) / 1e9

    log(
        # whole-step EFFECTIVE cell rate (cells actually executed / full-step
        # time) — NOT the SW kernel's standalone rate
        f"reads/s: {rps:.0f}  GCUPS(step-effective): {gcups:.2f}  mapped: {mapped}/{n_reads}"
        f"  truth accuracy (all batches): {ok}/{n_reads}"
        f"  marginal: {t_batch*1e3:.2f} ms/batch  fixed fetch: {fixed*1e3:.0f} ms"
        f"  walls: {walls[N1]*1e3:.1f}/{walls[N_BATCHES]*1e3:.1f} ms"
    )

    print(json.dumps({
        "metric": "reads_per_sec_per_chip",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / BASELINE_READS_PER_SEC, 3),
    }))


if __name__ == "__main__":
    main()
