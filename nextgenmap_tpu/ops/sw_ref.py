"""Banded Smith-Waterman — reference JAX implementation (score + traceback).

Reference analog: the OpenCL corridor-SW kernels SWOcl (score only,
ref:src/SWOcl.cpp) and SWOclCigar (traceback, ref:src/SWOclCigar.cpp), and
the SSE CPU backend that plays the same role (SURVEY.md §2 components 18-20).
This module is the pure-jax.lax kernel of our stack: it runs on any JAX
backend, defines the exact semantics any hand-written kernel must reproduce
bit-for-bit, and is itself oracle-tested against a scalar NumPy DP.

Band parametrization: query row i (0-based), band offset o in [0, W);
the corridor ref slice is laid out so ref index j = i + o.  A corridor of
length T = L + W therefore covers the whole band.  In these coordinates the
classic moves become:

  diag  (i-1, j-1) -> same offset o in the previous row
  up    (i-1, j)   -> offset o+1 in the previous row   (gap: query consumed, "I")
  left  (i,   j-1) -> offset o-1 in the same row       (gap: ref consumed, "D")

The left/F dependency inside a row is resolved with an associative max-scan
("lazy-F" trick): chains H->F->F… collapse exactly when gap_open >= gap_extend
(enforced by NgmConfig.validate), so

  F[o] = max_{t<o}( Htmp[t] + t*gext ) - gopen - (o-1)*gext

with Htmp = max(0, diag, E).  NGM's defaults (open == extend == 20) make the
affine recurrence collapse to linear gaps, so this one kernel covers both the
default and --affine modes.

DP is int32 throughout => tests assert exact equality (SURVEY.md §4 item 2).
Tie-breaks per DESIGN.md rule 10: stop > diag > up(E) > left(F); gap states
prefer open over extend on equal score; the global best cell prefers smallest
(i, then j).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

# plain int (NOT an eager jnp scalar: creating a JAX array at import time
# initializes the XLA backend, which breaks jax.distributed.initialize for
# any process that imports this module first)
NEG = -(2**30)

# traceback op codes (match SAM CIGAR semantics)
OP_M, OP_I, OP_D = 0, 1, 2
OP_NONE = 255

# dir byte layout: bits 0-1 H-source (0 stop, 1 diag, 2 E/up, 3 F/left),
# bit 2: E extends (vs opens), bit 3: F extends (vs opens),
# bit 4: exact base match at this cell (lets the backwalk skip re-reading
# query/ref — every per-step gather in the walk is a serial dependency)


class ScoreResult(NamedTuple):
    score: jax.Array   # [B] int32 best local score (0 = no alignment)
    end_i: jax.Array   # [B] int32 query index of the best cell
    end_o: jax.Array   # [B] int32 band offset of the best cell (ref j = i + o)


class AlignResult(NamedTuple):
    score: jax.Array     # [B] int32
    q_start: jax.Array   # [B] first aligned query base (soft-clip before)
    q_end: jax.Array     # [B] last aligned query base (inclusive)
    r_start: jax.Array   # [B] first aligned corridor ref index
    r_end: jax.Array     # [B] last aligned corridor ref index (inclusive)
    ops: jax.Array       # [B, max_ops] uint8, alignment ops END->START, OP_NONE-filled
    n_ops: jax.Array     # [B] int32
    matches: jax.Array   # [B] int32 exact base matches
    mismatches: jax.Array  # [B] int32 aligned-but-different bases
    indels: jax.Array    # [B] int32 total gap length
    trunc: jax.Array     # [B] bool — op buffer overflowed max_ops; the CIGAR
                         # is incomplete and the read must not be emitted



def _sub_scores(flat, n_mats, moff, qi, rw, simple=False):
    """Substitution scores without a gather.

    A naive `flat[qi*8 + rw]` lookup inside the row scan is a gather per
    DP row.
    The alphabet is 5 codes and the matrix count is tiny and static, so the
    lookup is instead built from vector compares/selects: per row compute
    Rq[c] = S[msel, qi, c] with M*25 scalar-coefficient selects on [B], then
    combine over the ref codes with 5 selects on [B, W].

    simple=True (static; scoring.matrices_are_simple) is the DEFAULT-mode
    fast path: every matrix is match-on-diagonal/one-mismatch-elsewhere, so
    the whole lookup is ONE equality compare + select — ~10 fewer
    elementwise ops per DP cell than the 5-plane combine.
    """
    if simple:
        match = flat[0]       # S[0, 0]
        mis = flat[1]         # S[0, 1] — shared by every non-diagonal entry
        hit = (rw == qi[:, None]) & (qi < 4)[:, None]
        return jnp.where(hit, match, mis)
    sub = jnp.zeros(rw.shape, jnp.int32)
    for c in range(5):
        rqc = jnp.zeros(qi.shape, jnp.int32)
        for m in range(n_mats):
            base = m * 64
            for a in range(5):
                coef = flat[base + a * 8 + c]
                sel = (qi == a) if n_mats == 1 else ((qi == a) & (moff == base))
                rqc = rqc + jnp.where(sel, coef, 0)
        sub = sub + jnp.where(rw == c, rqc[:, None], 0)
    return sub

def _row_step(sub, h_prev, e_prev, gopen_q, gopen_r, gext, local=True):
    """One DP row. Returns (h, e, htmp-F decomposition pieces for dirs).

    local=False is the --end-to-end (glocal) recurrence: no 0 floor, so the
    whole query must be consumed (row 0's zero h_prev still gives a free ref
    start anywhere in the corridor).
    """
    B, W = sub.shape
    # diag: previous row, same offset
    hd = h_prev + sub
    # E (up): previous row, offset o+1
    h_up = jnp.concatenate([h_prev[:, 1:], jnp.full((B, 1), NEG, h_prev.dtype)], axis=1)
    e_up = jnp.concatenate([e_prev[:, 1:], jnp.full((B, 1), NEG, e_prev.dtype)], axis=1)
    e_open = h_up - gopen_q
    e_ext = e_up - gext
    e = jnp.maximum(e_open, e_ext)
    base = jnp.maximum(0, hd) if local else hd
    htmp = jnp.maximum(base, e)
    # F (left) via exclusive max-scan of Htmp[t] + t*gext
    off = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    a = htmp + off * gext
    cm = jax.lax.associative_scan(jnp.maximum, a, axis=1)
    cm_excl = jnp.concatenate([jnp.full((B, 1), NEG, cm.dtype), cm[:, :-1]], axis=1)
    f = cm_excl - gopen_r - (off - 1) * gext
    h = jnp.maximum(htmp, f)
    return h, e, hd, f, e_ext, e_open


def _dirs(h, hd, e, f, e_ext_term, e_open_term, f_prev_ext, f_prev_open, mbit,
          local=True):
    """Pack the direction byte per cell (tie-breaks per DESIGN.md rule 10).

    glocal (--end-to-end) cells never encode "stop": the backwalk runs until
    the query is exhausted (row -1), not until the score hits 0.
    """
    src = jnp.where(h == hd, 1, jnp.where(h == e, 2, 3))
    d = (jnp.where(h <= 0, 0, src) if local else src).astype(jnp.uint8)
    e_bit = (e_ext_term > e_open_term).astype(jnp.uint8) << 2
    f_bit = (f_prev_ext > f_prev_open).astype(jnp.uint8) << 3
    m_bit = mbit.astype(jnp.uint8) << 4
    return d | e_bit | f_bit | m_bit


@partial(jax.jit, static_argnames=("band", "mode", "simple"))
def banded_sw_score(
    query: jax.Array,   # [B, L] int32/uint8 codes
    qlen: jax.Array,    # [B] int32
    ref: jax.Array,     # [B, T] codes, T = L + band
    matrix: jax.Array,  # [8, 8] int32
    gopen_q: jax.Array,  # scalar int32: penalty opening a gap consuming query (I)
    gopen_r: jax.Array,  # scalar int32: penalty opening a gap consuming ref (D)
    gext: jax.Array,     # scalar int32
    msel: jax.Array | None = None,  # [B] int32 matrix index (e.g. bisulfite strand)
    *,
    band: int,
    mode: str = "local",
    simple: bool = False,
) -> ScoreResult:
    """Score-only banded SW over a batch: ~L sequential steps of [B, W] work.

    `matrix` may be [8,8] (shared) or [M,8,8] with per-row selector `msel`.
    mode="glocal" (--end-to-end): whole query consumed, best cell taken from
    the last query row only; score <= 0 reports as 0 (unalignable).
    """
    local = mode == "local"
    B, L = query.shape
    W = band
    q = query.astype(jnp.int32)
    r = ref.astype(jnp.int32)
    flat = matrix.reshape(-1)
    n_mats = flat.shape[0] // 64
    moff = jnp.zeros((B,), jnp.int32) if msel is None else msel.astype(jnp.int32) * 64

    # lax.scan over rows; slices of q and r per row
    def body(carry, i):
        h_prev, e_prev, best, bi, bo = carry
        qi = jax.lax.dynamic_slice_in_dim(q, i, 1, axis=1)[:, 0]          # [B]
        rw = jax.lax.dynamic_slice_in_dim(r, i, W, axis=1)                # [B, W]
        sub = _sub_scores(flat, n_mats, moff, qi, rw, simple)
        h, e, *_ = _row_step(sub, h_prev, e_prev, gopen_q, gopen_r, gext, local)
        valid = ((i < qlen) if local else (i == qlen - 1))[:, None]
        h_m = jnp.where(valid, h, NEG)
        rowmax = jnp.maximum(jnp.max(h_m, axis=1), 0)
        rowarg = jnp.argmax(h_m, axis=1).astype(jnp.int32)
        upd = rowmax > best
        best = jnp.where(upd, rowmax, best)
        bi = jnp.where(upd, i, bi)
        bo = jnp.where(upd, rowarg, bo)
        return (h, e, best, bi, bo), None

    h0 = jnp.zeros((B, W), jnp.int32)
    e0 = jnp.full((B, W), NEG, jnp.int32)
    init = (h0, e0, jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32))
    (h, e, best, bi, bo), _ = jax.lax.scan(body, init, jnp.arange(L, dtype=jnp.int32))
    return ScoreResult(best, bi, bo)


@partial(jax.jit, static_argnames=("band", "max_ops", "mode", "simple"))
def banded_sw_align(
    query: jax.Array,
    qlen: jax.Array,
    ref: jax.Array,
    matrix: jax.Array,
    gopen_q: jax.Array,
    gopen_r: jax.Array,
    gext: jax.Array,
    msel: jax.Array | None = None,
    *,
    band: int,
    max_ops: int = 0,
    mode: str = "local",
    simple: bool = False,
) -> AlignResult:
    """Banded SW with full traceback: direction matrix + vectorized backwalk.

    The direction matrix is [B, L, W] uint8; the backwalk is a
    lax.while_loop of at most L+W steps with [B] gathers per step — only alignment survivors should be fed here.
    mode="glocal" (--end-to-end): whole query consumed, no clipping; the
    backwalk ends when the query is exhausted instead of at a 0 cell.
    """
    local = mode == "local"
    B, L = query.shape
    W = band
    MO = max_ops or (L + W)
    q = query.astype(jnp.int32)
    r = ref.astype(jnp.int32)
    flat = matrix.reshape(-1)
    n_mats = flat.shape[0] // 64
    moff = jnp.zeros((B,), jnp.int32) if msel is None else msel.astype(jnp.int32) * 64

    def body(carry, i):
        h_prev, e_prev, best, bi, bo = carry
        qi = jax.lax.dynamic_slice_in_dim(q, i, 1, axis=1)[:, 0]
        rw = jax.lax.dynamic_slice_in_dim(r, i, W, axis=1)
        sub = _sub_scores(flat, n_mats, moff, qi, rw, simple)
        B_, W_ = sub.shape
        hd = h_prev + sub
        h_up = jnp.concatenate([h_prev[:, 1:], jnp.full((B_, 1), NEG, jnp.int32)], axis=1)
        e_up = jnp.concatenate([e_prev[:, 1:], jnp.full((B_, 1), NEG, jnp.int32)], axis=1)
        e_open = h_up - gopen_q
        e_ext = e_up - gext
        e = jnp.maximum(e_open, e_ext)
        base = jnp.maximum(0, hd) if local else hd
        htmp = jnp.maximum(base, e)
        off = jax.lax.broadcasted_iota(jnp.int32, (B_, W_), 1)
        a = htmp + off * gext
        cm = jax.lax.associative_scan(jnp.maximum, a, axis=1)
        cm_excl = jnp.concatenate([jnp.full((B_, 1), NEG, jnp.int32), cm[:, :-1]], axis=1)
        f = cm_excl - gopen_r - (off - 1) * gext
        h = jnp.maximum(htmp, f)
        # F source bits: F[o] extends F[o-1] vs opens from Htmp[o-1] (strict:
        # prefer open on tie)
        f_left = jnp.concatenate([jnp.full((B_, 1), NEG, jnp.int32), f[:, :-1]], axis=1)
        htmp_left = jnp.concatenate([jnp.full((B_, 1), NEG, jnp.int32), htmp[:, :-1]], axis=1)
        # a "match" column is one whose substitution SCORE is positive, not
        # raw base equality: bisulfite/SLAM-tolerated conversions (T over C
        # scored +tol) must count toward identity or high-conversion reads
        # fail the -i filter wholesale (the reference relaxes bs-mode
        # identity the same way, ref:src/AlignmentBuffer.cpp ◆).  For the
        # default matrix sub > 0 <=> exact ACGT equality, bit-identical.
        mbit = sub > 0
        dirs = _dirs(h, hd, e, f, e_ext, e_open, f_left - gext,
                     htmp_left - gopen_r, mbit, local)
        valid = ((i < qlen) if local else (i == qlen - 1))[:, None]
        h_m = jnp.where(valid, h, NEG)
        rowmax = jnp.maximum(jnp.max(h_m, axis=1), 0)
        rowarg = jnp.argmax(h_m, axis=1).astype(jnp.int32)
        upd = rowmax > best
        best = jnp.where(upd, rowmax, best)
        bi = jnp.where(upd, i, bi)
        bo = jnp.where(upd, rowarg, bo)
        return (h, e, best, bi, bo), dirs

    h0 = jnp.zeros((B, W), jnp.int32)
    e0 = jnp.full((B, W), NEG, jnp.int32)
    init = (h0, e0, jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32))
    (_, _, best, bi, bo), dirs = jax.lax.scan(body, init, jnp.arange(L, dtype=jnp.int32))
    # dirs stays [L, B, W] uint8: the row-synchronized backwalk slices ONE
    # contiguous row [B, W] per iteration (cheap leading-axis dynamic slice),
    # instead of re-reading the whole [B, L*W] matrix per emitted op like the
    # old per-step walk did (~150x the HBM traffic at L=100/W=48)
    return _backwalk_rows(dirs, best, bi, bo, MO)


def _cummax(x, axis):
    return jax.lax.associative_scan(jnp.maximum, x, axis=axis)


def _extract_at(row_i32, o, W):
    """row[b, o[b]] without a gather: dense compare-sum over [B, W]."""
    col = jax.lax.broadcasted_iota(jnp.int32, row_i32.shape, 1)
    sel = (col == o[:, None]) & (o >= 0)[:, None] & (o < W)[:, None]
    return jnp.sum(jnp.where(sel, row_i32, 0), axis=1)


def _backwalk_rows(dirs, best, bi, bo, MO):
    """Row-synchronized traceback (SURVEY component 19, ref:src/SWOclCigar.cpp
    analog).

    One iteration per query row, top row first.  A read is processed in the
    iteration matching its current row: M/I consume one op and move up a row;
    a D run (gaps consuming reference only) stays WITHIN the row, so its whole
    length is resolved at once with a vectorized run-length trick — cont(c) =
    "the walk that just emitted D at cell c also emits D at c-1" =
    f_bit(c) | (hsrc(c-1) == 3); the run ends at the largest c <= o with
    ¬cont(c) (one cummax), after which the trail cell c-1 emits the row's
    closing M/I (or stops).  Per iteration: a few [B, W] compare-sums + two
    [B, MO] masked buffer writes — no gathers, no [B, L*W] re-reads.

    Bit-identical to the original per-step walk (asserted by
    tests/test_sw.py::test_row_walk_equivalence and the oracle tests).
    """
    L, B, W = dirs.shape
    PH_H, PH_E = 0, 1
    iota_mo = jax.lax.broadcasted_iota(jnp.int32, (B, MO), 1)

    def step(st, t):
        i_t = L - 1 - t
        row = jax.lax.dynamic_slice_in_dim(dirs, i_t, 1, axis=0)[0].astype(jnp.int32)
        o, ph = st["o"], st["ph"]
        sel = st["active"] & (st["i"] == i_t)

        d_entry = _extract_at(row, o, W)
        hsrc = d_entry & 3
        e_bit = (d_entry >> 2) & 1
        m_bit = (d_entry >> 4) & 1

        inb = (o >= 0) & (o < W)
        in_e = sel & inb & (ph == PH_E)
        at_h = sel & inb & (ph == PH_H)
        stop0 = at_h & (hsrc == 0)
        is_m1 = at_h & (hsrc == 1)
        is_i1 = at_h & (hsrc == 2)
        is_dr = at_h & (hsrc == 3)

        # ---- D run resolved in-row (hsrc == 3) ----
        hsrc3 = (row & 3) == 3
        f_bit_row = ((row >> 3) & 1) == 1
        hsrc3_left = jnp.concatenate(
            [jnp.zeros((B, 1), bool), hsrc3[:, :-1]], axis=1
        )
        cont = f_bit_row | hsrc3_left
        colw = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
        nc = jnp.where(~cont, colw, -1)
        last_nc = _cummax(nc, axis=1)                 # [B, W]
        ce = _extract_at(last_nc, o, W)               # run-end cell (or -1)
        k = jnp.where(is_dr, jnp.where(ce >= 0, o - ce + 1, o + 1), 0)
        o_trail = jnp.where(ce >= 0, ce - 1, -1)
        has_trail = is_dr & (o_trail >= 0)
        d_trail = jnp.where(has_trail, _extract_at(row, o_trail, W), 0)
        t_hsrc = d_trail & 3
        t_ebit = (d_trail >> 2) & 1
        t_mbit = (d_trail >> 4) & 1
        trail_m = has_trail & (t_hsrc == 1)
        trail_i = has_trail & (t_hsrc == 2)

        # ---- op emission into the END->START buffer at cursor c ----
        c = st["c"]
        emit_i = in_e | is_i1
        emit_m = is_m1
        kD = k                                        # 0 unless is_dr
        dmask = (iota_mo >= c[:, None]) & (iota_mo < (c + kD)[:, None])
        ops = jnp.where(dmask & is_dr[:, None], OP_D, st["ops"])
        single = jnp.where(
            emit_m, OP_M,
            jnp.where(emit_i, OP_I,
                      jnp.where(trail_m, OP_M,
                                jnp.where(trail_i, OP_I, OP_NONE))),
        )
        spos = c + kD
        has_single = emit_m | emit_i | trail_m | trail_i
        ops = jnp.where(
            (iota_mo == spos[:, None]) & has_single[:, None],
            single[:, None], ops,
        ).astype(jnp.uint8)
        # clamp the cursor to the buffer: a walk longer than MO ops
        # (reachable with interleaved I/D runs under user-set scoring) must
        # not report n_ops > ops.shape[1] — downstream formatters walk n_ops
        # entries.  The overflow is flagged per read instead.
        c_full = c + kD + has_single.astype(jnp.int32)
        trunc = st["trunc"] | (c_full > MO)
        c = jnp.minimum(c_full, MO)

        # ---- counters ----
        m_hit = (emit_m & (m_bit == 1)) | (trail_m & (t_mbit == 1))
        m_miss = (emit_m & (m_bit == 0)) | (trail_m & (t_mbit == 0))
        matches = st["matches"] + m_hit.astype(jnp.int32)
        mismatches = st["mismatches"] + m_miss.astype(jnp.int32)
        indels = st["indels"] + kD + emit_i.astype(jnp.int32) + trail_i.astype(jnp.int32)

        # ---- coordinates: last consumed cell wins ----
        qs = jnp.where(emit_m | emit_i | trail_m | trail_i, i_t, st["qs"])
        rs = jnp.where(
            trail_m, i_t + o_trail,
            jnp.where(is_dr & (k > 0), i_t + jnp.maximum(ce, 0),
                      jnp.where(emit_m, i_t + o, st["rs"])),
        )

        # ---- next state ----
        moved_up = emit_m | emit_i | trail_m | trail_i
        ni = jnp.where(moved_up, i_t - 1, st["i"])
        no = jnp.where(
            emit_i | trail_i,
            jnp.where(trail_i, o_trail + 1, o + 1),
            jnp.where(trail_m, o_trail, o),
        )
        nph = jnp.where(
            (emit_i & (e_bit == 1)) | (trail_i & (t_ebit == 1)), PH_E, PH_H
        )
        # deactivation: explicit stop, trail stop (t_hsrc==0 after a run),
        # a run falling off the band edge (ce == -1), or an out-of-band
        # position (the old per-step walk's inb check)
        dead = (
            stop0 | (is_dr & ~has_trail) | (has_trail & (t_hsrc == 0))
            | (sel & ~inb)
        )
        nst = {
            "i": jnp.where(sel, ni, st["i"]),
            "o": jnp.where(sel, no, o),
            "ph": jnp.where(sel, nph, ph),
            "active": st["active"] & ~dead,
            "c": c, "ops": ops, "trunc": trunc,
            "matches": matches, "mismatches": mismatches, "indels": indels,
            "qs": qs, "rs": rs,
        }
        return nst, None

    st0 = {
        "i": bi, "o": bo, "ph": jnp.zeros(B, jnp.int32),
        "active": best > 0,
        "c": jnp.zeros(B, jnp.int32),
        "trunc": jnp.zeros(B, bool),
        "ops": jnp.full((B, MO), OP_NONE, jnp.uint8),
        "matches": jnp.zeros(B, jnp.int32),
        "mismatches": jnp.zeros(B, jnp.int32),
        "indels": jnp.zeros(B, jnp.int32),
        "qs": bi, "rs": bi + bo,
    }
    st, _ = jax.lax.scan(step, st0, jnp.arange(L, dtype=jnp.int32))
    return AlignResult(
        score=best,
        q_start=st["qs"], q_end=bi,
        r_start=st["rs"], r_end=bi + bo,
        ops=st["ops"], n_ops=st["c"],
        matches=st["matches"], mismatches=st["mismatches"], indels=st["indels"],
        trunc=st["trunc"],
    )
