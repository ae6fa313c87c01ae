"""Banded-SW score kernel vs the scalar NumPy oracle on batched inputs.

Each row picks its own score matrix (msel, the strand-selected matrices of
the mapping step); every row's score and best cell (end_i, end_o) must equal
the oracle's exactly — the DP is integer.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from nextgenmap_tpu.config import NgmConfig
from nextgenmap_tpu.ops.scoring import matrices_are_simple, score_matrix
from nextgenmap_tpu.ops.sw_ref import banded_sw_align, banded_sw_score
from tests.oracle_sw import banded_sw_oracle

W = 48


def _args(q, lens, r, mats, msel, gaps=(20, 20, 20)):
    return (
        jnp.asarray(q), jnp.asarray(lens, jnp.int32), jnp.asarray(r),
        jnp.asarray(mats),
        jnp.int32(gaps[0]), jnp.int32(gaps[1]), jnp.int32(gaps[2]),
        jnp.asarray(msel, jnp.int32),
    )


def _assert_oracle(res, q, lens, r, mats, msel, band, gaps=(20, 20, 20)):
    for i in range(q.shape[0]):
        o = banded_sw_oracle(q[i], int(lens[i]), r[i], mats[msel[i]],
                             *gaps, band)
        got = (int(res.score[i]), int(res.end_i[i]), int(res.end_o[i]))
        assert got == (o["score"], o["end_i"], o["end_o"]), i


def test_score_matches_oracle_random():
    rng = np.random.default_rng(0)
    S, L = 16, 100
    cfg = NgmConfig()
    mats = np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])
    q = rng.integers(0, 4, (S, L)).astype(np.uint8)
    r = rng.integers(0, 5, (S, L + W)).astype(np.uint8)
    # plant exact matches for half the rows so real alignments exist
    for i in range(0, S, 2):
        o = int(rng.integers(0, W))
        r[i, o : o + L] = q[i]
    lens = rng.integers(20, L + 1, S).astype(np.int32)
    msel = rng.integers(0, 2, S).astype(np.int32)
    res = banded_sw_score(*_args(q, lens, r, mats, msel), band=W)
    _assert_oracle(res, q, lens, r, mats, msel, W)


def test_score_odd_lengths_and_sizes():
    rng = np.random.default_rng(1)
    S, L = 5, 73  # batch and length off any block multiple
    cfg = NgmConfig(match_bonus=7, mismatch_penalty=11)
    mats = score_matrix(cfg, 0)[None]
    q = rng.integers(0, 4, (S, L)).astype(np.uint8)
    r = rng.integers(0, 4, (S, L + W)).astype(np.uint8)
    r[0, 10 : 10 + L] = q[0]
    lens = np.array([L, 0, 31, L, 8], np.int32)
    msel = np.zeros(S, np.int32)
    res = banded_sw_score(*_args(q, lens, r, mats, msel), band=W)
    _assert_oracle(res, q, lens, r, mats, msel, W)


def test_score_asymmetric_gaps():
    rng = np.random.default_rng(2)
    S, L = 8, 64
    cfg = NgmConfig(gap_read_penalty=25, gap_ref_penalty=30,
                    gap_extend_penalty=12)
    mats = np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])
    q = rng.integers(0, 4, (S, L)).astype(np.uint8)
    r = rng.integers(0, 4, (S, L + W)).astype(np.uint8)
    for i in range(S):
        seg = q[i, : L - 6]
        r[i, 5 : 5 + seg.shape[0]] = seg  # near-full-length hit
    lens = np.full(S, L, np.int32)
    msel = rng.integers(0, 2, S).astype(np.int32)
    gaps = (25, 30, 12)
    res = banded_sw_score(*_args(q, lens, r, mats, msel, gaps), band=W)
    _assert_oracle(res, q, lens, r, mats, msel, W, gaps)


def test_score_simple_matrix_fast_path():
    """simple=True (match/mismatch matrix, the default mode) must agree with
    the oracle and with the general coefficient-plane path, for the score
    and the traceback kernels."""
    rng = np.random.default_rng(7)
    S, L = 16, 100
    cfg = NgmConfig()
    mats = np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])
    assert matrices_are_simple(mats)
    # bisulfite matrices are NOT simple (asymmetric tolerance entry)
    assert not matrices_are_simple(
        np.stack([score_matrix(cfg.replace(bs_mapping=True), 0),
                  score_matrix(cfg.replace(bs_mapping=True), 1)])
    )
    q = rng.integers(0, 5, (S, L)).astype(np.uint8)  # include N codes
    r = rng.integers(0, 5, (S, L + W)).astype(np.uint8)
    for i in range(0, S, 2):
        o = int(rng.integers(0, W))
        r[i, o : o + L] = q[i]
    lens = rng.integers(20, L + 1, S).astype(np.int32)
    msel = rng.integers(0, 2, S).astype(np.int32)
    args = _args(q, lens, r, mats, msel)
    for simple in (False, True):
        res = banded_sw_score(*args, band=W, simple=simple)
        _assert_oracle(res, q, lens, r, mats, msel, W)

    al = banded_sw_align(*args, band=W)
    al_s = banded_sw_align(*args, band=W, simple=True)
    for f in al._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(al, f)), np.asarray(getattr(al_s, f)), f
        )


@pytest.mark.parametrize("wide", [120, 184])
@pytest.mark.parametrize("simple", [False, True])
def test_score_wide_band_long_gap_runs(wide, simple):
    """W>64 bands must propagate lazy-F across the FULL band span.

    Regression: a doubling chain that stops at span 63 underestimates
    scores for gap runs >=64 band offsets (reads with a large deletion whose
    two anchors sit ~W apart in the corridor) — exactly the long-read
    corridors (W=120/184) of the 1000 bp path."""
    rng = np.random.default_rng(11)
    S, L = 8, 200
    cfg = NgmConfig()
    mats = np.stack([score_matrix(cfg, 0)])
    q = rng.integers(0, 4, (S, L)).astype(np.uint8)
    r = rng.integers(0, 4, (S, L + wide)).astype(np.uint8)
    for i in range(S):
        o2 = wide - 8  # second anchor nearly a full band away
        r[i, 0 : L // 2] = q[i, : L // 2]
        r[i, o2 + L // 2 : o2 + L] = q[i, L // 2 :]
    lens = np.full(S, L, np.int32)
    msel = np.zeros(S, np.int32)
    gaps = (20, 20, 3)
    res = banded_sw_score(*_args(q, lens, r, mats, msel, gaps), band=wide,
                          simple=simple)
    _assert_oracle(res, q, lens, r, mats, msel, wide, gaps)
