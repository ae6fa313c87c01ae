"""Word-gather CS path (round 4): row-gathered positions must be
bit-identical to the per-element gather path whenever the word budget
suffices, and loudly counted when it does not.

The path fetches positions as [B, HW] 8-wide rows instead of [B, H]
elements: one gather index per row of up to 8 hits instead of one per hit.
"""

import numpy as np

import jax.numpy as jnp

from nextgenmap_tpu.index.kmer_index import KmerIndex
from nextgenmap_tpu.io.simulate import random_genome
from nextgenmap_tpu.ops.candidate import (
    candidate_search_canonical, candidate_search_dual, pack_offsets,
    pad_positions8,
)
from nextgenmap_tpu.ops.kmer import extract_kmers, extract_kmers_canonical


def _cands_equal(a, b, check_overflow=True):
    for f in ("bucket", "score", "strand", "best_score", "extra_score"):
        assert (np.asarray(getattr(a, f)) == np.asarray(getattr(b, f))).all(), f
    assert int(a.fanout_overflow) == int(b.fanout_overflow)
    assert int(a.cmr_overflow) == int(b.cmr_overflow)
    if check_overflow:
        assert int(a.hit_overflow) == int(b.hit_overflow)


def _canonical_setup(seed, genome_size=30_000, k=11, n_reads=48, read_len=80,
                     max_freq=200):
    g = random_genome(genome_size, seed=seed)
    idx = KmerIndex.build(g, k=k, skip=1, max_freq=max_freq,
                          canonical=True)
    off, pos = idx.device_arrays()
    rng = np.random.default_rng(seed + 1)
    starts = rng.integers(0, genome_size - read_len, size=n_reads)
    reads = np.stack([g[s: s + read_len] for s in starts])
    lens = np.full(n_reads, read_len, np.int32)
    canon, flip, ok = extract_kmers_canonical(reads, lens, k, stride=2)
    return g, off, pos, canon, flip, ok, lens


def test_word_gather_canonical_identical():
    g, off, pos, canon, flip, ok, lens = _canonical_setup(81)
    pos8 = pad_positions8(jnp.asarray(pos))
    kw = dict(k=11, fanout_cap=16, hit_cap=128, max_cmrs=8, diag_bin_log2=4,
              stride=2)
    base = candidate_search_canonical(
        canon, flip, ok, lens, jnp.asarray(off), pos8,
        jnp.float32(0.5), jnp.int32(200), **kw)
    word = candidate_search_canonical(
        canon, flip, ok, lens, jnp.asarray(off), pos8,
        jnp.float32(0.5), jnp.int32(200), word_cap=64, **kw)
    _cands_equal(base, word)


def test_word_gather_packed_offsets_identical():
    g, off, pos, canon, flip, ok, lens = _canonical_setup(83)
    pos8 = pad_positions8(jnp.asarray(pos))
    packed = pack_offsets(jnp.asarray(off), 200, 16)
    assert packed is not None
    kw = dict(k=11, fanout_cap=16, hit_cap=128, max_cmrs=8, diag_bin_log2=4,
              stride=2)
    base = candidate_search_canonical(
        canon, flip, ok, lens, packed, pos8,
        jnp.float32(0.5), jnp.int32(200), packed_offsets=True, **kw)
    word = candidate_search_canonical(
        canon, flip, ok, lens, packed, pos8,
        jnp.float32(0.5), jnp.int32(200), packed_offsets=True, word_cap=64,
        **kw)
    _cands_equal(base, word)


def test_word_gather_repeat_rich_straddles():
    """Repeat-dense tiny-k index: multi-element CSR rows whose o0 straddles
    word boundaries exercise the straddle accounting (wcnt, rel lanes)."""
    g = random_genome(6_000, seed=85)
    k = 7                                       # dense rows at tiny k
    idx = KmerIndex.build(g, k=k, skip=1, max_freq=1000, canonical=True)
    off, pos = idx.device_arrays()
    rng = np.random.default_rng(86)
    starts = rng.integers(0, 6_000 - 60, size=32)
    reads = np.stack([g[s: s + 60] for s in starts])
    lens = np.full(32, 60, np.int32)
    canon, flip, ok = extract_kmers_canonical(reads, lens, k, stride=1)
    pos8 = pad_positions8(jnp.asarray(pos))
    kw = dict(k=k, fanout_cap=32, hit_cap=256, max_cmrs=8, diag_bin_log2=4,
              stride=1)
    base = candidate_search_canonical(
        canon, flip, ok, lens, jnp.asarray(off), pos8,
        jnp.float32(0.5), jnp.int32(1000), **kw)
    # generous word budget: every word fits, results identical
    word = candidate_search_canonical(
        canon, flip, ok, lens, jnp.asarray(off), pos8,
        jnp.float32(0.5), jnp.int32(1000), word_cap=256, **kw)
    _cands_equal(base, word)


def test_word_gather_dual_identical():
    """Two-strand (non-canonical) search through the word path."""
    g = random_genome(25_000, seed=87)
    idx = KmerIndex.build(g, k=11, skip=1, max_freq=200)
    off, pos = idx.device_arrays()
    rng = np.random.default_rng(88)
    starts = rng.integers(0, 25_000 - 80, size=32)
    reads = np.stack([g[s: s + 80] for s in starts])
    lens = np.full(32, 80, np.int32)
    km_f, ok_f = extract_kmers(reads, lens, 11, stride=2)
    km_r, ok_r = extract_kmers(reads[:, ::-1], lens, 11, stride=2)
    pos8 = pad_positions8(jnp.asarray(pos))
    kw = dict(fanout_cap=16, hit_cap=128, max_cmrs=8, diag_bin_log2=4,
              stride=2)
    base = candidate_search_dual(
        km_f, ok_f, km_r, ok_r, jnp.asarray(off), pos8,
        jnp.float32(0.5), jnp.int32(200), **kw)
    word = candidate_search_dual(
        km_f, ok_f, km_r, ok_r, jnp.asarray(off), pos8,
        jnp.float32(0.5), jnp.int32(200), word_cap=64, **kw)
    _cands_equal(base, word)


def test_word_overflow_counted_not_silent():
    """A starved word budget must raise hit_overflow, not silently differ."""
    g, off, pos, canon, flip, ok, lens = _canonical_setup(89)
    pos8 = pad_positions8(jnp.asarray(pos))
    kw = dict(k=11, fanout_cap=16, hit_cap=128, max_cmrs=8, diag_bin_log2=4,
              stride=2)
    starved = candidate_search_canonical(
        canon, flip, ok, lens, jnp.asarray(off), pos8,
        jnp.float32(0.5), jnp.int32(200), word_cap=8, **kw)
    assert int(starved.hit_overflow) > 0


def test_unpadded_positions_fall_back():
    """positions not padded to 8 -> the word path silently degrades to the
    element-gather path (same results, no shape error)."""
    g, off, pos, canon, flip, ok, lens = _canonical_setup(91)
    pos_j = jnp.asarray(pos)
    if pos_j.shape[0] % 8 == 0:
        pos_j = pos_j[:-1]                       # force unpadded length
    kw = dict(k=11, fanout_cap=16, hit_cap=128, max_cmrs=8, diag_bin_log2=4,
              stride=2)
    a = candidate_search_canonical(
        canon, flip, ok, lens, jnp.asarray(off), pos_j,
        jnp.float32(0.5), jnp.int32(200), **kw)
    b = candidate_search_canonical(
        canon, flip, ok, lens, jnp.asarray(off), pos_j,
        jnp.float32(0.5), jnp.int32(200), word_cap=64, **kw)
    _cands_equal(a, b)


def test_map_step_word_toggle_identical(ecoli_like, monkeypatch):
    """Full map_step through the Mapper with the word path on vs off."""
    from nextgenmap_tpu.config import NgmConfig
    from nextgenmap_tpu.index.genome import Genome
    from nextgenmap_tpu.io.simulate import simulate_reads_fast
    from nextgenmap_tpu.models.mapper import Mapper

    g = ecoli_like[:60_000]
    genome = Genome(
        codes=g, names=["chr1"],
        starts=np.array([0], np.int64),
        lengths=np.array([len(g)], np.int64),
    )
    cfg = NgmConfig(kmer=11)
    codes, _, _ = simulate_reads_fast(g, 64, read_len=80, snp_rate=0.02,
                                      seed=92)
    lens = np.full(64, 80, np.int32)
    outs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("NGM_WORD_GATHER", flag)
        m = Mapper(cfg, genome, read_len=80)
        assert (m.word_cap > 0) == (flag == "1")
        outs[flag] = m.map_batch(codes, lens)
    a, b = outs["1"], outs["0"]
    for f in ("mapped", "strand", "pos", "mapq", "score", "ops", "n_ops"):
        assert (np.asarray(getattr(a, f)) == np.asarray(getattr(b, f))).all(), f
