"""Device-built CSR index must be lookup-equivalent to the host build."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nextgenmap_tpu.index.device_build import build_index_device
from nextgenmap_tpu.index.kmer_index import KmerIndex


def test_device_build_matches_host(ecoli_like):
    g = ecoli_like[:40_000]
    k, skip = 8, 2
    host = KmerIndex.build(g, k=k, skip=skip, max_freq=1 << 30)  # no masking
    off_d, pos_d = build_index_device(jnp.asarray(g), k=k, skip=skip)
    off_d = np.asarray(off_d)
    pos_d = np.asarray(pos_d)
    # every real bucket's row must match exactly (ascending order included)
    assert np.array_equal(off_d[: 4**k + 1], host.offsets)
    n = int(host.offsets[-1])
    assert np.array_equal(pos_d[:n], host.positions.astype(np.int32))


def test_device_build_invalid_windows_routed_out():
    g = np.array([0, 1, 2, 3, 4, 0, 1, 2, 3, 0, 1] + [0] * 10, dtype=np.uint8)
    k = 3
    off_d, pos_d = build_index_device(jnp.asarray(g), k=k, skip=1)
    off_d = np.asarray(off_d)
    nb = 4**k
    # windows covering the N at index 4 fall in the overflow bucket
    n_invalid = off_d[nb + 1] - off_d[nb]
    assert n_invalid == 3  # windows starting at 2, 3, 4
    # all real-bucket positions valid
    total_real = off_d[nb]
    assert total_real == (g.shape[0] - k + 1) - 3


def test_device_build_collapse_ct(ecoli_like):
    g = ecoli_like[:5_000]
    host = KmerIndex.build(g, k=8, skip=1, max_freq=1 << 30, collapse="ct")
    off_d, pos_d = build_index_device(jnp.asarray(g), k=8, skip=1, collapse="ct")
    assert np.array_equal(np.asarray(off_d)[: 4**8 + 1], host.offsets)


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_build_cutoff_from_memory_limit(monkeypatch):
    """The device build runs while ~25x the genome fits the device's
    bytes_limit; a device reporting no limit (the CPU) keeps the fixed
    2^28-base cutoff."""
    import jax

    from nextgenmap_tpu.pipeline import runner

    monkeypatch.setattr(jax, "local_devices",
                        lambda: [_Dev({"bytes_limit": 25_000})])
    assert runner.device_build_fits(1_000)
    assert not runner.device_build_fits(1_001)
    monkeypatch.setattr(jax, "local_devices", lambda: [_Dev(None)])
    assert runner.device_build_fits(1 << 28)
    assert not runner.device_build_fits((1 << 28) + 1)


def test_device_build_cutoff_int32_bound(monkeypatch):
    """However much memory the device has (here an 80 GB card's limit), a
    genome whose coordinates overflow the device build's int32 positions
    goes to the host build."""
    import jax

    from nextgenmap_tpu.pipeline import runner

    monkeypatch.setattr(jax, "local_devices",
                        lambda: [_Dev({"bytes_limit": 64 * 10**9})])
    assert runner.device_build_fits(2**31 - 1)
    assert not runner.device_build_fits(2**31)
    assert not runner.device_build_fits(2_500_000_000)


@pytest.mark.parametrize("G,canonical,ok", [
    (2**31 - 1, False, True), (2**31, False, False),
    (2**30 - 1, True, True), (2**30, True, False),
])
def test_device_build_refuses_int32_overflow(G, canonical, ok):
    """Past int32 coordinates (2^30 for canonical (pos << 1) entries) the
    device build raises instead of wrapping; traced only, nothing is
    allocated."""
    spec = jax.ShapeDtypeStruct((G,), jnp.uint8)
    build = lambda g: build_index_device(g, k=13, skip=1, canonical=canonical)
    if ok:
        off, pos = jax.eval_shape(build, spec)
        assert pos.shape == (G - 12,)
    else:
        with pytest.raises(ValueError, match="int32"):
            jax.eval_shape(build, spec)


def test_bisulfite_tables_refuse_int32_overflow():
    """CT + GA positions share one int32-offset array; past 2^31 entries
    the Mapper refuses instead of wrapping the GA offsets."""
    from types import SimpleNamespace

    from nextgenmap_tpu.config import NgmConfig
    from nextgenmap_tpu.io.simulate import random_genome
    from nextgenmap_tpu.models.mapper import Mapper

    half = SimpleNamespace(positions=np.broadcast_to(np.uint32(0), (2**30,)))
    genome = SimpleNamespace(codes=random_genome(1_000, seed=1))
    cfg = NgmConfig(kmer=8, bs_mapping=True, skip_save=True)
    with pytest.raises(ValueError, match="int32"):
        Mapper(cfg, genome, 100, index=(half, half))
