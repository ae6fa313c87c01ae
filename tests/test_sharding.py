"""Sharding tests on the 8-virtual-device CPU mesh (SURVEY.md §4 item 6):
sharded runs must be record-identical to single-device runs, for both
data-parallel and index-sharded meshes, single- and paired-end."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from nextgenmap_tpu.config import NgmConfig
from nextgenmap_tpu.index.kmer_index import KmerIndex
from nextgenmap_tpu.io.simulate import random_genome, simulate_pairs, simulate_reads
from nextgenmap_tpu.models.mapper import map_step, map_step_paired
from nextgenmap_tpu.ops.scoring import score_matrix
from nextgenmap_tpu.parallel.dp import make_dp_map_step
from nextgenmap_tpu.parallel.index_shard import ShardedIndex, make_index_sharded_map_step
from nextgenmap_tpu.parallel.mesh import make_mesh

K = 11
CFG = NgmConfig(kmer=K)


@pytest.fixture(scope="module")
def setup():
    g = random_genome(64_000, seed=77)
    idx = KmerIndex.build(g, k=K, skip=2, max_freq=1000)
    off, pos = idx.device_arrays()
    reads = simulate_reads(g, 64, read_len=100, snp_rate=0.03, indel_rate=0.003, seed=13)
    codes = np.stack([r.codes for r in reads])
    lens = np.full(64, 100, np.int32)
    pairs = simulate_pairs(g, 32, read_len=100, insert_mean=300, insert_sd=30,
                           snp_rate=0.02, seed=14)
    pcodes = np.stack([m.codes for p in pairs for m in p])
    plens = np.full(64, 100, np.int32)
    mats = np.stack([score_matrix(CFG, 0), score_matrix(CFG, 1)])
    band = CFG.corridor_for(100)
    statics = dict(k=K, fanout_cap=CFG.max_kmer_fanout, max_cmrs=CFG.max_cmrs,
                   diag_bin_log2=CFG.diag_bin_log2, band=band, min_kmer_hits=1)
    return dict(g=g, idx=idx, off=off, pos=pos, codes=codes, lens=lens,
                pcodes=pcodes, plens=plens, mats=mats, statics=statics)


def se_args(s):
    return (
        jnp.asarray(s["g"]), jnp.asarray(s["off"]), jnp.asarray(s["pos"]),
        jnp.asarray(s["codes"]), jnp.asarray(s["lens"]), jnp.asarray(s["mats"]),
        jnp.int32(20), jnp.int32(20), jnp.int32(20),
        jnp.float32(0.5), jnp.int32(1000), jnp.float32(0.65), jnp.float32(0.5),
    )


def pe_args(s):
    return (
        jnp.asarray(s["g"]), jnp.asarray(s["off"]), jnp.asarray(s["pos"]),
        jnp.asarray(s["pcodes"]), jnp.asarray(s["plens"]), jnp.asarray(s["mats"]),
        jnp.int32(20), jnp.int32(20), jnp.int32(20),
        jnp.float32(0.5), jnp.int32(1000), jnp.float32(0.65), jnp.float32(0.5),
        jnp.int32(0), jnp.int32(1000), jnp.float32(0.9),
    )


def assert_results_equal(a, b, fields=None, skip=()):
    fields = fields or [f for f in a._fields if not f.endswith("overflow")]
    for f in fields:
        if f in skip:
            continue
        av, bv = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert np.array_equal(av, bv), f"field {f} differs"


def test_dp_single_end_identical(setup):
    s = setup
    single = map_step(*se_args(s), **s["statics"])
    fn = make_dp_map_step(make_mesh(8), paired=False, **s["statics"])
    sharded = fn(*se_args(s))
    assert_results_equal(single, sharded)
    assert int(single.mapped.sum()) >= 60


def test_dp_paired_identical(setup):
    s = setup
    single = map_step_paired(*pe_args(s), **s["statics"])
    fn = make_dp_map_step(make_mesh(8), paired=True, **s["statics"])
    sharded = fn(*pe_args(s))
    assert_results_equal(single, sharded)
    assert int(single.proper.sum()) >= 56


@pytest.mark.parametrize("n_shards", [2, 4])
def test_index_sharded_single_end(setup, n_shards):
    s = setup
    single = map_step(*se_args(s), **s["statics"])
    halo = ShardedIndex.halo_for(CFG, 100, paired=False)
    sidx = ShardedIndex.build(s["idx"], s["g"], n_shards, halo)
    mesh = make_mesh(8, index_shards=n_shards)
    fn = make_index_sharded_map_step(mesh, paired=False, read_len=100, **s["statics"])
    args = se_args(s)
    sharded = fn(
        jnp.asarray(sidx.genome), jnp.asarray(sidx.offsets),
        jnp.asarray(sidx.positions), jnp.asarray(sidx.base),
        jnp.asarray(sidx.core_lo), jnp.asarray(sidx.core_hi),
        *args[3:],
    )
    # positions/strand/score must agree with the global-index run
    assert np.array_equal(np.asarray(single.mapped), np.asarray(sharded.mapped))
    assert np.array_equal(np.asarray(single.pos),
                          np.asarray(sharded.pos).astype(np.int64))
    assert np.array_equal(np.asarray(single.strand), np.asarray(sharded.strand))
    assert np.array_equal(np.asarray(single.score), np.asarray(sharded.score))
    assert np.array_equal(np.asarray(single.ops), np.asarray(sharded.ops))
    assert np.array_equal(np.asarray(single.mapq), np.asarray(sharded.mapq))


def test_index_sharded_paired(setup):
    s = setup
    single = map_step_paired(*pe_args(s), **s["statics"])
    halo = ShardedIndex.halo_for(CFG, 100, paired=True)
    sidx = ShardedIndex.build(s["idx"], s["g"], 4, halo)
    mesh = make_mesh(8, index_shards=4)
    fn = make_index_sharded_map_step(mesh, paired=True, read_len=100, **s["statics"])
    args = pe_args(s)
    sharded = fn(
        jnp.asarray(sidx.genome), jnp.asarray(sidx.offsets),
        jnp.asarray(sidx.positions), jnp.asarray(sidx.base),
        jnp.asarray(sidx.core_lo), jnp.asarray(sidx.core_hi),
        *args[3:],
    )
    assert np.array_equal(np.asarray(single.mapped), np.asarray(sharded.mapped))
    assert np.array_equal(np.asarray(single.pos),
                          np.asarray(sharded.pos).astype(np.int64))
    assert np.array_equal(np.asarray(single.proper), np.asarray(sharded.proper))
    assert np.array_equal(np.asarray(single.score), np.asarray(sharded.score))


def test_shard_count_invariance(setup):
    """DESIGN.md rule 15: shard count never changes output."""
    s = setup
    halo = ShardedIndex.halo_for(CFG, 100, paired=False)
    outs = []
    for n_shards in (2, 4, 8):
        sidx = ShardedIndex.build(s["idx"], s["g"], n_shards, halo)
        mesh = make_mesh(8, index_shards=n_shards)
        fn = make_index_sharded_map_step(mesh, paired=False, read_len=100,
                                         **s["statics"])
        args = se_args(s)
        r = fn(
            jnp.asarray(sidx.genome), jnp.asarray(sidx.offsets),
            jnp.asarray(sidx.positions), jnp.asarray(sidx.base),
            jnp.asarray(sidx.core_lo), jnp.asarray(sidx.core_hi),
            *args[3:],
        )
        outs.append((np.asarray(r.pos), np.asarray(r.score), np.asarray(r.mapq)))
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            assert np.array_equal(a, b)


def test_shard_csr_native_matches_numpy(setup):
    """Native CSR shard-slicing == the numpy route, array for array."""
    from nextgenmap_tpu import native

    assert native.lib() is not None
    s = setup
    halo = ShardedIndex.halo_for(CFG, 100, paired=False)
    a = ShardedIndex.build(s["idx"], s["g"], 3, halo)
    old = native._LIB, native._TRIED
    native._LIB, native._TRIED = None, True
    try:
        b = ShardedIndex.build(s["idx"], s["g"], 3, halo)
    finally:
        native._LIB, native._TRIED = old
    for f in ("genome", "offsets", "positions", "base", "core_lo", "core_hi"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f

def test_sharded_scan_matches_mesh_and_single(setup):
    """map_step_sharded_scan (the ONE-program sequential loop) must equal
    both the global-index run and the mesh path, field for field."""
    from nextgenmap_tpu.models.mapper import map_step_sharded_scan

    s = setup
    single = map_step(*se_args(s), **s["statics"])
    halo = ShardedIndex.halo_for(CFG, 100, paired=False)
    sidx = ShardedIndex.build(s["idx"], s["g"], 3, halo)
    args = se_args(s)
    scan = map_step_sharded_scan(
        jnp.asarray(sidx.genome), jnp.asarray(sidx.offsets),
        jnp.asarray(sidx.positions), jnp.asarray(sidx.base),
        jnp.asarray(sidx.core_lo), jnp.asarray(sidx.core_hi),
        *args[3:], paired=False, read_len=100, **s["statics"],
    )
    assert np.array_equal(np.asarray(single.mapped), np.asarray(scan.mapped))
    assert np.array_equal(np.asarray(single.pos),
                          np.asarray(scan.pos).astype(np.int64))
    assert np.array_equal(np.asarray(single.strand), np.asarray(scan.strand))
    assert np.array_equal(np.asarray(single.score), np.asarray(scan.score))
    assert np.array_equal(np.asarray(single.ops), np.asarray(scan.ops))
    assert np.array_equal(np.asarray(single.mapq), np.asarray(scan.mapq))
    # the phase-1 shard pass has no global floor, so its LOCAL-threshold
    # overflow count floods on non-owning shards (measured 34845 bogus
    # overflows over 20k reads at config-4); phase 2 must recount against
    # the global threshold, matching the honest unsharded counter here
    assert int(scan.cmr_overflow) == int(single.cmr_overflow)


def test_sharded_scan_paired_matches_single(setup):
    from nextgenmap_tpu.models.mapper import map_step_sharded_scan

    s = setup
    single = map_step_paired(*pe_args(s), **s["statics"])
    halo = ShardedIndex.halo_for(CFG, 100, paired=True)
    sidx = ShardedIndex.build(s["idx"], s["g"], 4, halo)
    args = pe_args(s)
    scan = map_step_sharded_scan(
        jnp.asarray(sidx.genome), jnp.asarray(sidx.offsets),
        jnp.asarray(sidx.positions), jnp.asarray(sidx.base),
        jnp.asarray(sidx.core_lo), jnp.asarray(sidx.core_hi),
        *args[3:], paired=True, read_len=100, **s["statics"],
    )
    assert np.array_equal(np.asarray(single.mapped), np.asarray(scan.mapped))
    assert np.array_equal(np.asarray(single.pos),
                          np.asarray(scan.pos).astype(np.int64))
    assert np.array_equal(np.asarray(single.proper), np.asarray(scan.proper))
    assert np.array_equal(np.asarray(single.score), np.asarray(scan.score))


def test_canonical_sharded_matches_canonical_single(setup):
    """CANONICAL index sharding (round-3: (pos<<1)|flip entries slice with
    doubled bounds and rebase back into int32) — both the sequential scan
    and the mesh path must equal the canonical global-index run."""
    from nextgenmap_tpu.models.mapper import map_step_sharded_scan

    s = setup
    cidx = KmerIndex.build(s["g"], k=K, skip=2, max_freq=1000, canonical=True)
    assert cidx.canonical
    off, pos = cidx.device_arrays()
    statics = dict(s["statics"], canonical=True)
    args = se_args(s)
    single = map_step(
        args[0], jnp.asarray(off), jnp.asarray(pos), *args[3:], **statics
    )
    halo = ShardedIndex.halo_for(CFG, 100, paired=False)
    sidx = ShardedIndex.build(cidx, s["g"], 3, halo)
    assert sidx.canonical
    shard_args = (
        jnp.asarray(sidx.genome), jnp.asarray(sidx.offsets),
        jnp.asarray(sidx.positions), jnp.asarray(sidx.base),
        jnp.asarray(sidx.core_lo), jnp.asarray(sidx.core_hi),
    )
    scan = map_step_sharded_scan(
        *shard_args, *args[3:], paired=False, read_len=100, **statics,
    )
    for f in ("mapped", "strand", "score", "ops", "mapq", "cmr_overflow"):
        assert np.array_equal(
            np.asarray(getattr(single, f)), np.asarray(getattr(scan, f))
        ), f
    assert np.array_equal(np.asarray(single.pos),
                          np.asarray(scan.pos).astype(np.int64))
    # canonical actually found the same reads as the non-canonical baseline
    base = map_step(*se_args(s), **s["statics"])
    assert np.asarray(single.mapped).sum() >= np.asarray(base.mapped).sum() - 1

    sidx4 = ShardedIndex.build(cidx, s["g"], 4, halo)
    mesh = make_mesh(8, index_shards=4)
    fn = make_index_sharded_map_step(mesh, paired=False, read_len=100,
                                     **statics)
    sharded = fn(
        jnp.asarray(sidx4.genome), jnp.asarray(sidx4.offsets),
        jnp.asarray(sidx4.positions), jnp.asarray(sidx4.base),
        jnp.asarray(sidx4.core_lo), jnp.asarray(sidx4.core_hi),
        *args[3:],
    )
    for f in ("mapped", "strand", "score", "mapq"):
        assert np.array_equal(
            np.asarray(getattr(single, f)), np.asarray(getattr(sharded, f))
        ), f
    assert np.array_equal(np.asarray(single.pos),
                          np.asarray(sharded.pos).astype(np.int64))


def test_megabatch_scan_matches_separate_calls(setup):
    """map_step_scan over K stacked batches == K separate map_step calls,
    field for field (SE and PE) — the megabatch program is pure dispatch
    amortization, never a semantic change."""
    from nextgenmap_tpu.models.mapper import map_step_scan

    s = setup
    args = se_args(s)
    codes, lens = args[3], args[4]
    # 3 distinct batches: slices of the 64-read fixture (pad to equal B)
    ks = [codes[0:32], codes[16:48], codes[32:64]]
    kl = [lens[0:32]] * 3
    singles = [
        map_step(*args[:3], c, l, *args[5:], **s["statics"])
        for c, l in zip(ks, kl)
    ]
    stacked = map_step_scan(
        *args[:3], jnp.stack(ks), jnp.stack(kl), *args[5:],
        paired=False, **s["statics"],
    )
    for i, single in enumerate(singles):
        row = type(single)(*[jnp.asarray(getattr(stacked, f))[i]
                             for f in single._fields])
        assert_results_equal(single, row)

    pargs = pe_args(s)
    pcodes, plens = pargs[3], pargs[4]
    pk = [pcodes[0:32], pcodes[32:64]]
    pl = [plens[0:32]] * 2
    psingles = [
        map_step_paired(*pargs[:3], c, l, *pargs[5:], **s["statics"])
        for c, l in zip(pk, pl)
    ]
    pstacked = map_step_scan(
        *pargs[:3], jnp.stack(pk), jnp.stack(pl), *pargs[5:13],
        pargs[13], pargs[14], pargs[15],
        paired=True, **s["statics"],
    )
    for i, single in enumerate(psingles):
        row = type(single)(*[jnp.asarray(getattr(pstacked, f))[i]
                             for f in single._fields])
        assert_results_equal(single, row)


@pytest.mark.parametrize("ish", [1, 2, 4])
def test_mesh_tables_placed_per_device(setup, ish):
    """A mesh Mapper places its tables on the mesh devices when it is built:
    replicated over dp, one position-range row per ish column.  Left on the
    default device, the whole index would sit there and be copied out again
    at every step."""
    from nextgenmap_tpu.models.mapper import Mapper

    class _G:
        codes = setup["g"]

    cfg = NgmConfig(kmer=K, index_shards=ish, devices=4, batch_size=64)
    mapper = Mapper(cfg, _G(), 100, index=setup["idx"])
    mesh_devs = set(jax.local_devices()[:4])
    if ish == 1:
        for x in (mapper._genome_dev, mapper._off_dev, mapper._pos_dev):
            assert x.sharding.device_set == mesh_devs
            assert x.sharding.is_fully_replicated
        return
    pos = mapper._ish_args[2]
    assert pos.sharding.device_set == mesh_devs
    rows = mapper._sharded.positions
    for shard in pos.addressable_shards:
        s = shard.index[0].start
        np.testing.assert_array_equal(np.asarray(shard.data)[0], rows[s])


@pytest.mark.parametrize("devices", [1, 4])
def test_pair_straddling_shard_boundary(setup, devices):
    """A proper pair whose mates lie on both sides of a shard boundary maps
    as it does unsharded.  The pair comes from the shard owning mate 1, where
    mate 2 sits in the halo past the core: its score and position must come
    from there (it used to come back unmapped, with MAPQ from the shard
    owning mate 2's copy)."""
    from nextgenmap_tpu.io.encode import revcomp_codes
    from nextgenmap_tpu.models.mapper import Mapper

    g = setup["g"]

    class _G:
        codes = g

    S = 4
    bound = g.shape[0] // S * 2                  # a core boundary (2 of 4)
    L, pairs = 100, []
    for p1 in range(bound - 160, bound - 60, 10):   # mate 1 before it
        p2 = p1 + 250                                # mate 2 past it
        pairs += [g[p1:p1 + L], revcomp_codes(g[p2:p2 + L])]
    codes = np.stack(pairs).astype(np.uint8)
    lens = np.full(codes.shape[0], L, np.int32)
    cfg = NgmConfig(kmer=K, batch_size=codes.shape[0])
    want = Mapper(cfg, _G(), L, index=setup["idx"]).map_batch_paired(
        codes, lens)
    got = Mapper(cfg.replace(index_shards=S, devices=devices), _G(), L,
                 index=setup["idx"]).map_batch_paired(codes, lens)
    assert np.asarray(want.proper).all()
    for f in ("mapped", "pos", "strand", "score", "mapq", "proper", "n_ops"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      np.asarray(getattr(got, f)), f)
