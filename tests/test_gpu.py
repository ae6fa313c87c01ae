"""The mapping step's device kernels, compiled for an NVIDIA GPU, against their
plain references at the widths the mapper runs.

Every test needs a GPU (the `gpu` fixture decides at run time and skips
elsewhere); `python chip_smoke.py` runs this file on the card.  The DP is
int32 and the matmul formulations are exact by construction (bf16 operands
holding small integers, f32 accumulation, every sum < 2^24), so every
comparison is exact.
"""

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import nextgenmap_tpu.ops.kmer as km
from nextgenmap_tpu.config import NgmConfig
from nextgenmap_tpu.io.simulate import simulate_corridors
from nextgenmap_tpu.ops.gather import take_rows_mxu
from nextgenmap_tpu.ops.scoring import score_matrix
from nextgenmap_tpu.ops.sw_ref import banded_sw_align, banded_sw_score
from tests.oracle_sw import banded_sw_oracle

pytestmark = pytest.mark.gpu

CFG = NgmConfig()


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX found {dev.platform}); "
                    "chip_smoke.py runs these on the card")
    return dev


@pytest.mark.parametrize("n,read_len", [(512, 150), (64, 1000)])
def test_sw_score_and_align_match_oracle(gpu, n, read_len):
    """[512, 150] x W56 (short reads) and [64, 1000] x W184 (long reads),
    bands from corridor_for, every row checked against the scalar oracle."""
    band = CFG.corridor_for(read_len)
    q, r = simulate_corridors(n, read_len, band, seed=read_len)
    lens = np.full(n, read_len, np.int32)
    lens[::7] = read_len - 13          # some rows shorter than the batch
    mats = np.stack([score_matrix(CFG, 0), score_matrix(CFG, 1)])
    msel = np.arange(n, dtype=np.int32) % 2
    args = (
        jnp.asarray(q), jnp.asarray(lens), jnp.asarray(r), jnp.asarray(mats),
        jnp.int32(20), jnp.int32(20), jnp.int32(20), jnp.asarray(msel),
    )
    sc = jax.device_get(banded_sw_score(*args, band=band, simple=True))
    al = jax.device_get(banded_sw_align(*args, band=band, simple=True))
    # the scalar oracle takes ~0.1-1 s a row: spread it over host processes
    # (spawned: they import numpy and the oracle only, never JAX)
    with ProcessPoolExecutor(
        max_workers=min(16, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("spawn"),
    ) as pool:
        oracle = list(pool.map(
            banded_sw_oracle, q, lens.tolist(), r, mats[msel],
            [20] * n, [20] * n, [20] * n, [band] * n, chunksize=4,
        ))
    for i, o in enumerate(oracle):
        assert (sc.score[i], sc.end_i[i], sc.end_o[i]) == (
            o["score"], o["end_i"], o["end_o"]), i
        assert al.ops[i, : al.n_ops[i]].tolist() == o["ops"], i
        for f in ("score", "q_start", "q_end", "r_start", "r_end",
                  "matches", "mismatches", "indels"):
            assert int(getattr(al, f)[i]) == o[f], (i, f)
        assert not al.trunc[i], i


def _kmers_with_backend(monkeypatch, backend, fn, *args):
    """fn (an unjitted extractor) under `backend`, in a jit of a NEW function:
    the backend is read at trace time and jit caches traces by function."""
    monkeypatch.setattr(km, "_KMER_BACKEND", backend)
    return jax.device_get(jax.jit(lambda c, l: fn(c, l, *args))(*_batch()))


def _batch():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 5, (4096, 150)).astype(np.uint8)   # incl. N
    lens = rng.integers(13, 151, 4096).astype(np.int32)
    return jnp.asarray(codes), jnp.asarray(lens)


def test_kmer_matmul_backend_matches_slice(gpu, monkeypatch):
    """Banded-matmul k-mers == the strided-slice loop at [4096, 150]."""
    for fn in (km.extract_kmers_canonical.__wrapped__,
               km.extract_kmers.__wrapped__):
        a = _kmers_with_backend(monkeypatch, "slice", fn, 13, 2)
        b = _kmers_with_backend(monkeypatch, "mxu", fn, 13, 2)
        ok = a[-1]
        np.testing.assert_array_equal(ok, b[-1])
        for x, y in zip(a[:-1], b[:-1]):
            np.testing.assert_array_equal(x[ok], y[ok])


def test_take_rows_matmul_matches_take(gpu):
    """One-hot matmul row fetch == jnp.take at the score pass's shape
    ([2B, L] = [8192, 150] table, B/2 = 2048 slot rows)."""
    rng = np.random.default_rng(6)
    stack = jnp.asarray(rng.integers(0, 5, (8192, 150)).astype(np.uint8))
    rows = jnp.asarray(rng.integers(0, 8192, 2048).astype(np.int32))
    got = jax.jit(take_rows_mxu)(stack, rows)
    want = jax.jit(lambda s, i: jnp.take(s, i, axis=0))(stack, rows)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
