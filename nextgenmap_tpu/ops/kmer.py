"""Device-side k-mer extraction over read batches.

Reference analog: ``CS::PrefixIteration`` (ref:src/CS.cpp) — the per-read
k-mer enumerator feeding index lookups.  Here it is a jitted rolling-hash
over the whole ``[B, L]`` batch at once; k is static so the window combine
unrolls to k vector ops.

Read-side k-mers are enumerated at stride ``read_kmer_skip`` (kmer_skip and
read_kmer_skip must not both exceed 1, or stride phases can miss a locus;
see DESIGN.md).

Bisulfite collapse modes (SURVEY.md §2 component 22): "ct" hashes C as T
(forward pass: a C->T-converted read still hits its locus against the
CT-collapsed index); "ga" hashes G as A (reverse-complement pass: the rc of
an original-bottom-strand read shows G->A against the forward genome, so it
is searched in the GA-collapsed index).
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from nextgenmap_tpu.io.encode import CODE_A, CODE_C, CODE_G, CODE_T

# k-mer windowing backend: "mxu" computes the rolling hash as banded bf16
# matmuls (see _window_matmul), "slice" is the strided-slice loop.  The
# default was chosen on another chip; not measured on the H100 end to end.
# Bit-identical (coefficients are powers of two, every accumulation < 2^24,
# so bf16 x bf16 -> f32 products are exact; tests assert equality).
_KMER_BACKEND = os.environ.get("NGM_KMER_BACKEND", "mxu")


def _band_weights(L: int, Q: int, k: int, stride: int, coeffs) -> np.ndarray:
    """[L, Q] banded matrix: W[l, q] = coeffs[l - q*stride] (else 0)."""
    W = np.zeros((L, Q), np.float32)
    for q in range(Q):
        s = q * stride
        e = min(s + k, L)       # L < k windows are ok-masked anyway
        W[s:e, q] = coeffs[:e - s]
    return W


def _window_matmul(x: jax.Array, L: int, Q: int, k: int, stride: int,
                   coeffs: np.ndarray) -> jax.Array:
    """Σ_j coeffs[j] * x[:, q*stride + j] for all windows, as one matmul.

    x must hold small non-negative ints (codes/flags); coeffs power-of-two
    scaled so every product and windowed sum stays < 2^24 (f32-exact).
    """
    W = jnp.asarray(_band_weights(L, Q, k, stride, coeffs), jnp.bfloat16)
    return jnp.dot(
        x.astype(jnp.bfloat16), W, preferred_element_type=jnp.float32
    ).astype(jnp.int32)


def _rolling_kmers_mxu(c: jax.Array, L: int, Q: int, k: int, stride: int,
                       rev: bool = False) -> jax.Array:
    """The rolling hash Σ_j c[q*stride+j] << 2*(k-1-j) (or << 2*j when rev)
    as TWO banded matmuls.  Split hi/lo so both partial sums < 4^7 = 2^14
    (exact in f32 accumulation); c must be pre-masked to 0..3."""
    exp = np.arange(k)[::-1] if not rev else np.arange(k)
    co = (4.0 ** exp).astype(np.float64)
    hi_mask = co >= 4.0 ** 7
    lo = _window_matmul(c, L, Q, k, stride, np.where(hi_mask, 0, co))
    if not hi_mask.any():
        return lo
    hi = _window_matmul(c, L, Q, k, stride, np.where(hi_mask, co / 4.0 ** 7, 0))
    return (hi << 14) + lo


def collapse_codes(c: jax.Array, collapse: str) -> jax.Array:
    if collapse == "ct":
        return jnp.where(c == CODE_C, CODE_T, c)
    if collapse == "ga":
        return jnp.where(c == CODE_G, CODE_A, c)
    assert collapse == "none", collapse
    return c


@partial(jax.jit, static_argnames=("k", "stride", "collapse", "max_collapsed"))
def extract_kmers(codes: jax.Array, lengths: jax.Array, k: int, stride: int = 1,
                  collapse: str = "none", max_collapsed: int = 0):
    """Rolling k-mer values for a read batch.

    Args:
      codes: [B, L] uint8/int32 base codes (0..3 bases, 4 = N/pad).
      lengths: [B] int32 true read lengths.
      k: k-mer length (static, <= 15 so values fit int32 for k<=13; int32 is
         fine up to 4^15 < 2^31).
      stride: read-side enumeration stride (static).
      collapse: "none" | "ct" (hash C as T) | "ga" (hash G as A).
      max_collapsed: bisulfite --bs-cutoff — drop k-mers with more than this
        many collapsed bases (C for "ct", G for "ga"): after collapsing they
        carry too little sequence information and only fan out to repeats.
        0 = no limit.

    Returns:
      (kmers [B, Q] int32, valid [B, Q] bool) with Q = (L-k)//stride + 1.
      Invalid where the window contains non-ACGT or runs past the read end.
    """
    B, L = codes.shape
    Q = max(1, (L - k) // stride + 1)
    c0 = codes.astype(jnp.int32)
    c = collapse_codes(c0, collapse)
    collapsed_from = {"ct": CODE_C, "ga": CODE_G}.get(collapse)
    if _KMER_BACKEND == "mxu":
        bad = (c >= 4).astype(jnp.int32)
        cm = jnp.where(bad > 0, 0, c)            # N contributes 0; ok masks it
        vals = _rolling_kmers_mxu(cm, L, Q, k, stride)
        ones = np.ones(k, np.float64)
        nbad = _window_matmul(bad, L, Q, k, stride, ones)
        ok = nbad == 0
        if collapsed_from is not None and max_collapsed > 0:
            ncoll = _window_matmul(
                (c0 == collapsed_from).astype(jnp.int32), L, Q, k, stride, ones
            )
            ok &= ncoll <= max_collapsed
    else:
        vals = jnp.zeros((B, Q), dtype=jnp.int32)
        ok = jnp.ones((B, Q), dtype=bool)
        ncoll = jnp.zeros((B, Q), dtype=jnp.int32)
        for j in range(k):
            w = jax.lax.slice(
                c, (0, j), (B, j + (Q - 1) * stride + 1), (1, stride)
            )
            vals = (vals << 2) | (w & 3)
            ok &= w < 4
            if collapsed_from is not None and max_collapsed > 0:
                w0 = jax.lax.slice(
                    c0, (0, j), (B, j + (Q - 1) * stride + 1), (1, stride)
                )
                ncoll = ncoll + (w0 == collapsed_from).astype(jnp.int32)
        if collapsed_from is not None and max_collapsed > 0:
            ok &= ncoll <= max_collapsed
    # windows running past the read's true length are invalid
    qpos = jax.lax.broadcasted_iota(jnp.int32, (B, Q), 1) * stride
    ok &= qpos + k <= lengths[:, None]
    return vals, ok


@partial(jax.jit, static_argnames=("k", "stride"))
def extract_kmers_canonical(codes: jax.Array, lengths: jax.Array, k: int,
                            stride: int = 1):
    """Canonical k-mers of the FORWARD read only.

    canonical = min(kmer, revcomp(kmer)); one index lookup covers both
    strands (element gathers are the CS hot spot — this halves them vs the
    two-strand enumeration).  Returns (canon [B,Q] int32, flip [B,Q] int32
    1 where revcomp(kmer) < kmer, valid [B,Q] bool).
    """
    B, L = codes.shape
    Q = max(1, (L - k) // stride + 1)
    c = codes.astype(jnp.int32)
    if _KMER_BACKEND == "mxu":
        bad = (c >= 4).astype(jnp.int32)
        cm = jnp.where(bad > 0, 0, c)
        vals = _rolling_kmers_mxu(cm, L, Q, k, stride)
        # revcomp value: Σ (3 - c_j) << 2j — compute Σ c_j << 2j by matmul
        # and subtract from the all-3s constant (3-c of an N window is
        # garbage either way; ok masks it)
        rsum = _rolling_kmers_mxu(cm, L, Q, k, stride, rev=True)
        all3 = ((1 << (2 * k)) - 1)
        rvals = all3 - rsum
        nbad = _window_matmul(bad, L, Q, k, stride, np.ones(k, np.float64))
        ok = nbad == 0
    else:
        vals = jnp.zeros((B, Q), dtype=jnp.int32)
        rvals = jnp.zeros((B, Q), dtype=jnp.int32)
        ok = jnp.ones((B, Q), dtype=bool)
        for j in range(k):
            w = jax.lax.slice(
                c, (0, j), (B, j + (Q - 1) * stride + 1), (1, stride)
            )
            vals = (vals << 2) | (w & 3)
            rvals = rvals | ((3 - (w & 3)) << (2 * j))
            ok &= w < 4
    qpos = jax.lax.broadcasted_iota(jnp.int32, (B, Q), 1) * stride
    ok &= qpos + k <= lengths[:, None]
    flip = (rvals < vals).astype(jnp.int32)
    canon = jnp.minimum(vals, rvals)
    return canon, flip, ok
