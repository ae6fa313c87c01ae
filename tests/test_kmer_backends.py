"""MXU banded-matmul k-mer extraction == the strided-slice loop, exactly.

The mxu backend computes the rolling hash as bf16 banded matmuls whose
coefficients are powers of two and whose accumulations stay < 2^24, so the
f32 MXU results are exact (ops/kmer.py).  Equality is asserted on every
valid window (invalid windows are ok-masked by every consumer).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import nextgenmap_tpu.ops.kmer as km


@pytest.fixture
def batch():
    rng = np.random.default_rng(42)
    codes = rng.integers(0, 5, (48, 151)).astype(np.uint8)  # incl. N=4
    lens = rng.integers(13, 152, 48).astype(np.int32)
    return jnp.asarray(codes), jnp.asarray(lens)


def _both(monkeypatch, fn):
    """fn() under each backend.  The backend is read at trace time, so each
    runs the unjitted extractor (`__wrapped__`) under a jit of a NEW
    function: jit caches traces by function, and a cache hit would silently
    reuse the first backend's program."""
    outs = []
    for backend in ("slice", "mxu"):
        monkeypatch.setattr(km, "_KMER_BACKEND", backend)
        outs.append(jax.jit(lambda: fn())())
    return outs


@pytest.mark.parametrize("k,stride", [(13, 2), (13, 1), (14, 2), (11, 3)])
def test_extract_kmers_backends_equal(batch, monkeypatch, k, stride):
    codes, lens = batch
    (v1, o1), (v2, o2) = _both(
        monkeypatch, lambda: km.extract_kmers.__wrapped__(codes, lens, k, stride)
    )
    ok = np.asarray(o1)
    assert (ok == np.asarray(o2)).all()
    assert (np.asarray(v1)[ok] == np.asarray(v2)[ok]).all()


@pytest.mark.parametrize("k,stride", [(13, 2), (14, 1)])
def test_extract_canonical_backends_equal(batch, monkeypatch, k, stride):
    codes, lens = batch
    a, b = _both(
        monkeypatch,
        lambda: km.extract_kmers_canonical.__wrapped__(codes, lens, k, stride),
    )
    ok = np.asarray(a[2])
    assert (ok == np.asarray(b[2])).all()
    assert (np.asarray(a[0])[ok] == np.asarray(b[0])[ok]).all()
    assert (np.asarray(a[1])[ok] == np.asarray(b[1])[ok]).all()


@pytest.mark.parametrize("collapse,mc", [("ct", 3), ("ga", 2), ("ct", 0)])
def test_extract_bisulfite_backends_equal(batch, monkeypatch, collapse, mc):
    codes, lens = batch
    (v1, o1), (v2, o2) = _both(
        monkeypatch,
        lambda: km.extract_kmers.__wrapped__(
            codes, lens, 13, 2, collapse=collapse, max_collapsed=mc
        ),
    )
    ok = np.asarray(o1)
    assert (ok == np.asarray(o2)).all()
    assert (np.asarray(v1)[ok] == np.asarray(v2)[ok]).all()
