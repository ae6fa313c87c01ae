"""Candidate search (CS) — jitted, batched, fixed-shape, hit-compacted.

Reference analog: the CS task (ref:src/CS.cpp): per read, look every k-mer up
in the index, bin the returned reference positions by diagonal
(refPos − readOffset) into a counting hash table ("CSSearchTable"), and keep
regions whose hit count clears an adaptive threshold relative to the best
region (scaled by --sensitivity) as Candidate Mapping Regions.  The reference
counts BOTH strands in one table and thresholds against the single best
region; we do the same.

Device design (DESIGN.md rules 1-8).  The ragged CSR fan-out is the
enemy: a dense [B, kmers, K] gather wastes >95% of its random device-memory
traffic when the mean CSR row length is <1 (E. coli at k=13: 2.3M positions
over 67M rows).  So hits are COMPACTED first:

  1. Per-kmer CSR row lengths via two offset lookups; per-kmer cap K.
  2. Exclusive prefix-sum assigns each real hit a slot h < H (static per-read
     cap).  Slot ownership (which kmer owns slot h) is a dense [B, H, Qt]
     compare-and-sum — elementwise work, no gather.
  3. ONE [B, H] element gather fetches exactly the real positions.
  4. Diagonal quantization; strand-tagged vote values (strand in a high bit)
     so one sort + one stable top_k yields the merged candidate list with
     DESIGN.md rule 6/7 tie-breaking (score DESC, fwd first, bucket ASC).
  5. DOUBLE-VOTE pair-merge: every hit votes for buckets b and b−1, so the
     vote count of b equals hits(b) + hits(b+1) with no post-hoc gather.
  6. Run lengths of the sorted votes via ONE forward cummax, evaluated at run
     ENDS (no reverse/flipped scan).

Every static cap reports an overflow count so lost candidates are auditable.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

# plain int, not an eager jnp scalar (which would init the XLA backend at
# import and break jax.distributed.initialize)
SENTINEL = 2**31 - 1  # bucket value for invalid hits; sorts last

_BIAS = 1 << 16        # vote bias so negative diagonals stay sortable
_STRAND_OFF = 1 << 28  # strand tag above any biased bucket


class Candidates(NamedTuple):
    bucket: jax.Array          # [B, C] int32 diagonal bucket (SENTINEL = none)
    score: jax.Array           # [B, C] int32 pair-merged hit count (0 = none)
    strand: jax.Array          # [B, C] int32 0 fwd / 1 rev
    best_score: jax.Array      # [B] int32 best bucket score for the read,
                               # globalized across index shards (pmax over
                               # axis_name / max with best_floor) when sharded
    fanout_overflow: jax.Array  # [] int32 — k-mer rows truncated by K
    hit_overflow: jax.Array     # [] int32 — reads truncated by the H cap
    cmr_overflow: jax.Array     # [] int32 — reads with > C surviving CMRs
    extra_score: jax.Array      # [B] int32 the (C+1)-th best eligible bucket
                               # score (0 if fewer than C+1 eligible): lets a
                               # floorless phase-1 shard pass be re-counted
                               # against the GLOBAL threshold later
                               # (#eligible > C  <=>  extra_score >= thresh)


def _cummax(x, axis):
    return jax.lax.associative_scan(jnp.maximum, x, axis=axis)


PACK_CNT_BITS = 6          # low bits hold min(row length, 63)
PACK_MAX_POSITIONS = 1 << (32 - PACK_CNT_BITS)  # o0 must fit the high bits


def pack_offsets(offsets: jax.Array, max_freq, fanout_cap: int):
    """Pack CSR (o0, row length) pairs into ONE uint32 table, or None.

    The plain layout needs TWO offset gathers per k-mer (o0 and o1).  Packing
    `o0 << 6 | min(len, 63)` halves that.  Repeat masking (row length >
    max_freq => treat as empty) is baked in at pack time — identical to the
    lookup-time mask since both use the run's max_kmer_freq.  Only valid
    when every o0 < 2^26 (genomes/indices under ~67M positions) and
    fanout_cap < 63 (so the 63 saturation can never hide a real overflow).

    For concatenated dual tables (bisulfite) the join entry is garbage but
    also never indexed (k-mer ids stay within each half); a zero pad keeps
    the table length — and therefore the table_split stride — unchanged.
    """
    if fanout_cap >= (1 << PACK_CNT_BITS) - 1:
        return None
    n_pos = int(offsets[-1])
    if n_pos >= PACK_MAX_POSITIONS:
        return None
    off = jnp.asarray(offsets)
    cnt = off[1:] - off[:-1]
    cnt = jnp.where(cnt > max_freq, 0, jnp.minimum(cnt, (1 << PACK_CNT_BITS) - 1))
    packed = (off[:-1].astype(jnp.uint32) << PACK_CNT_BITS) | cnt.astype(jnp.uint32)
    return jnp.concatenate([packed, jnp.zeros((1,), jnp.uint32)])


def _slot_owners_dense(cum, o0, payload, H, extras=()):
    """Slot ownership via dense [B, H, Qt] compare-sums (fast for small H).

    extras: additional per-kmer [B, Qt] arrays to resolve at each slot via
    the same one-hot sum (the word-gather path needs the owner's cumw/w0);
    when non-empty the return gains a 4th element (tuple of [B, H] arrays).
    """
    B, Qt = cum.shape
    harange = jax.lax.broadcasted_iota(jnp.int32, (B, H), 1)
    ge = harange[:, :, None] >= cum[:, None, :]          # [B, H, Qt]
    qid = jnp.sum(ge.astype(jnp.int32), axis=2) - 1      # [B, H]
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (B, H, Qt), 2) == qid[:, :, None]
    )
    cum_at = jnp.sum(jnp.where(onehot, cum[:, None, :], 0), axis=2)
    o0_at = jnp.sum(jnp.where(onehot, o0[:, None, :], 0), axis=2)
    pidx = o0_at + (harange - cum_at)
    pay_at = None
    if payload is not None:
        pay_at = jnp.sum(jnp.where(onehot, payload[:, None, :], 0), axis=2)
    if extras:
        ex_at = tuple(
            jnp.sum(jnp.where(onehot, e[:, None, :], 0), axis=2)
            for e in extras
        )
        return qid, pidx, pay_at, ex_at
    return qid, pidx, pay_at


def _slot_owners_dense2(cum, o0, payload, H):
    """Slot ownership in TWO dense [B, H, Qt] passes (r3, vs classic dense's
    ~5): pass 1 max-reduces the packed (q, payload) of eligible k-mers
    (cum <= h; q ascending so max = last = the owner), pass 2 one-hot-sums
    the owner's delta = o0 - cum, from which pidx = delta + h.  The per-q
    cum/o0 combine happens once on [B, Qt] instead of per slot."""
    B, Qt = cum.shape
    harange = jax.lax.broadcasted_iota(jnp.int32, (B, H), 1)
    ge = harange[:, :, None] >= cum[:, None, :]          # [B, H, Qt]
    q_iota = jax.lax.broadcasted_iota(jnp.int32, (B, Qt), 1)
    qp = q_iota * 2 + (payload if payload is not None else 0)
    v1 = jnp.max(jnp.where(ge, qp[:, None, :], -1), axis=2)   # [B, H]
    qid = v1 >> 1
    pay_at = (v1 & 1) if payload is not None else None
    delta = o0 - cum                                     # [B, Qt]
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (B, H, Qt), 2) == qid[:, :, None]
    )
    delta_at = jnp.sum(jnp.where(onehot, delta[:, None, :], 0), axis=2)
    pidx = delta_at + harange
    return qid, pidx, pay_at


def _slot_owners_dense1(cum, o0, payload, H, transposed=False):
    """Slot ownership in ONE dense pass + flat [B, H] gathers (round 3).

    dense resolves ownership with ~5 fused [B, H, Qt] compare/one-hot passes
    and dense2 with two; both re-scan the dense tensor to extract the
    owner's delta = o0 - cum by one-hot sum.  But the max-reduce that finds
    the owner (qp = q*2+payload is increasing in q, so max over eligible
    q == last eligible q == dense's sum(ge)-1, including cnt==0 ties)
    already yields qid — and delta/payload for H slots are then ONE flat
    bandwidth-bound element gather, not another dense pass.  Unlike bisect there is no
    serialized gather chain: one dense pass, one gather, done.

    transposed=True lays the dense tensor out [B, Qt, H] (reduce over the
    MIDDLE axis, H minor): whole rows accumulate elementwise instead of a
    reduction over the (padded) Qt minor axis per output element.
    """
    B, Qt = cum.shape
    harange = jax.lax.broadcasted_iota(jnp.int32, (B, H), 1)
    q_iota = jax.lax.broadcasted_iota(jnp.int32, (B, Qt), 1)
    qp = q_iota * 2 + (payload if payload is not None else 0)
    if transposed:
        ge = cum[:, :, None] <= harange[:, None, :]          # [B, Qt, H]
        v1 = jnp.max(jnp.where(ge, qp[:, :, None], -1), axis=1)
    else:
        ge = harange[:, :, None] >= cum[:, None, :]          # [B, H, Qt]
        v1 = jnp.max(jnp.where(ge, qp[:, None, :], -1), axis=2)
    qid = v1 >> 1                     # cum[0] == 0 => always >= 0
    pay_at = (v1 & 1) if payload is not None else None
    rowoff = jax.lax.broadcasted_iota(jnp.int32, (B, H), 0) * Qt
    delta = (o0 - cum).reshape(-1)
    pidx = delta[(rowoff + qid).reshape(-1)].reshape(B, H) + harange
    return qid, pidx, pay_at


def _slot_owners_sorted(cum, o0, payload, H):
    """Slot ownership via a rank-merge: two sorts, no scatters/gathers.

    The dense variant's [B, H, Qt] tensors scale ~H·Qt in memory traffic
    and collapse at gigabase hit caps.  Here the
    nondecreasing `cum` row is MERGED with the slot iota by one sort (even
    keys = k-mer boundaries, odd keys = slots, so cum <= h ties resolve
    inclusively); a cummax over int64-packed (qid, flip, o0-cum) payloads
    carries each slot's owning k-mer; a second stable sort compacts the
    slot elements back out.  O((Qt+H) log(Qt+H)) per row.
    """
    B, Qt = cum.shape
    harange = jax.lax.broadcasted_iota(jnp.int32, (B, H), 1)
    key = jnp.concatenate([cum * 2, harange * 2 + 1], axis=1)  # [B, Qt+H]
    q_iota = jax.lax.broadcasted_iota(jnp.int32, (B, Qt), 1)
    qp = q_iota * 2 + (payload if payload is not None else 0)  # q<<1 | flip
    pay = jnp.concatenate([qp, jnp.full((B, H), -1, jnp.int32)], axis=1)
    key_s, pay_s = jax.lax.sort((key, pay), dimension=1, num_keys=1)
    run = _cummax(pay_s, axis=1)        # owning k-mer so far (monotone in q)
    # compact the slot elements (odd keys) back to [B, H]; they appear in
    # ascending h order, and the stable sort preserves that
    is_slot = (key_s & 1).astype(jnp.int32)
    _, run_h = jax.lax.sort((1 - is_slot, run), dimension=1, num_keys=1)
    run_h = run_h[:, :H]
    qid = run_h >> 1
    pay_at = (run_h & 1) if payload is not None else None
    # one small [B, H] gather resolves the owner's o0 - cum
    delta = o0 - cum
    delta_at = jnp.take_along_axis(delta, jnp.clip(qid, 0, Qt - 1), axis=1)
    pidx = delta_at + harange
    return qid, pidx, pay_at


def _slot_owners_scatter(cum, o0, payload, H, cnt):
    """Slot ownership via equality-scatter + forward-fill.

    The dense variant resolves ownership with ~5 fused [B, H, Qt] passes
    (a >=-compare sum for qid, then one-hot masked sums for cum/o0/payload).
    Here each REAL k-mer (cnt > 0) *writes* its packed record at its starting
    slot cum[q] — an == one-hot reduced over q, exactly TWO [B, Qt, H]
    passes — and a single [B, H] forward-fill scan propagates the record
    across the k-mer's run of slots.  Writers have strictly increasing cum,
    so at most one k-mer writes per slot, and the fill carries (qid, flip,
    o0-cum) together.  Layout matters as much as the pass count: the [B,Qt,H]
    tensors reduce over the MIDDLE axis with H minor, so whole rows
    accumulate elementwise, where the dense variant reduces over its minor
    axis (a reduction per output element).
    """
    B, Qt = cum.shape
    harange = jax.lax.broadcasted_iota(jnp.int32, (B, H), 1)
    q_iota = jax.lax.broadcasted_iota(jnp.int32, (B, Qt), 1)
    # +1 so 0 means "no writer"; payload (flip bit) rides the LSB
    qp = q_iota * 2 + (payload if payload is not None else 0) + 1
    delta = o0 - cum                       # pidx = delta + h within the run
    cumw = jnp.where(cnt > 0, cum, -1)     # non-writers never match a slot
    eq = cumw[:, :, None] == harange[:, None, :]          # [B, Qt, H]
    scat_q = jnp.sum(jnp.where(eq, qp[:, :, None], 0), axis=1)     # [B, H]
    scat_d = jnp.sum(jnp.where(eq, delta[:, :, None], 0), axis=1)

    def fill(a, b):  # forward-fill: last writer at or before this slot wins
        take_b = b[0] > 0
        return (jnp.where(take_b, b[0], a[0]), jnp.where(take_b, b[1], a[1]))

    fq, fd = jax.lax.associative_scan(fill, (scat_q, scat_d), axis=1)
    qid = (fq - 1) >> 1
    pay_at = ((fq - 1) & 1) if payload is not None else None
    pidx = fd + harange
    return qid, pidx, pay_at


def _slot_owners_bisect(cum, o0, payload, H):
    """Slot ownership via batched binary search — the round-3 default.

    The key structural fact every O(H·Qt) variant above ignores: `cum` is
    NONDECREASING along Qt (it is a prefix sum).  "The last k-mer q with
    cum[q] <= h" is therefore searchsorted(cum, h, side=right)-1 — computed
    for all [B, H] slots with ceil(log2(Qt)) rounds of FLAT element gathers
    instead of dense/scatter compare-reductions over [B, H, Qt] or the two
    [B, Qt+H] sorts of the rank-merge.  Exactly dense semantics, including cnt==0 ties (the
    last tied q wins both there and under side=right).  Scales to gigabase
    hit caps: O(H log Qt) with no dense tensor at any H.
    """
    import math

    B, Qt = cum.shape
    harange = jax.lax.broadcasted_iota(jnp.int32, (B, H), 1)
    rowoff = jax.lax.broadcasted_iota(jnp.int32, (B, H), 0) * Qt
    flat_cum = cum.reshape(-1)
    lo = jnp.zeros((B, H), jnp.int32)   # invariant: cum[lo] <= h (cum[0]=0)
    hi = jnp.full((B, H), Qt - 1, jnp.int32)
    for _ in range(max(1, math.ceil(math.log2(max(2, Qt))))):
        mid = (lo + hi + 1) >> 1
        v = flat_cum[(rowoff + mid).reshape(-1)].reshape(B, H)
        ok = v <= harange
        lo = jnp.where(ok, mid, lo)
        hi = jnp.where(ok, hi, mid - 1)
    qid = lo
    fq = (rowoff + qid).reshape(-1)
    delta = (o0 - cum).reshape(-1)
    pidx = delta[fq].reshape(B, H) + harange
    pay_at = (
        payload.reshape(-1)[fq].reshape(B, H) if payload is not None else None
    )
    return qid, pidx, pay_at


# above this hit cap the dense [B, H, Qt] ownership tensors cost more
# memory traffic than the alternatives; below it dense won.  Tuned on
# another chip; not measured on the H100.
_DENSE_H_MAX = 256
# ownership strategy: "auto" = dense at H <= _DENSE_H_MAX, else bisect;
# "dense"/"sorted"/"scatter"/"bisect" force a variant (A/B probes + test
# oracles).  Read at trace time: set the env (or monkeypatch) BEFORE the
# first jit call.
import os as _os

_OWNERS_MODE = _os.environ.get("NGM_OWNERS", "auto")


def _slot_owners(cum, o0, payload, H, cnt):
    mode = _OWNERS_MODE
    if mode == "auto":
        # dense below _DENSE_H_MAX; above it the dense tensors grow as
        # H x Qt and the rank-merge sort takes over
        mode = "dense" if H <= _DENSE_H_MAX else "sorted"
    if mode == "bisect":
        return _slot_owners_bisect(cum, o0, payload, H)
    if mode == "scatter":
        return _slot_owners_scatter(cum, o0, payload, H, cnt)
    if mode == "dense":
        return _slot_owners_dense(cum, o0, payload, H)
    if mode == "dense2":
        return _slot_owners_dense2(cum, o0, payload, H)
    if mode == "dense1":
        return _slot_owners_dense1(cum, o0, payload, H)
    if mode == "dense1t":
        return _slot_owners_dense1(cum, o0, payload, H, transposed=True)
    return _slot_owners_sorted(cum, o0, payload, H)


WORD_W = 8  # positions per gathered row (32 B): one row gather fetches up
            # to 8 hits (tuned on another chip; not measured on the H100)


def pad_positions8(positions):
    """Pad a positions array to a multiple of WORD_W (zeros) so the
    word-gather path can view it as [P/8, 8] rows for free.  Padding entries
    are never validated (cnt masks stop at the true row ends); callers that
    skip padding silently fall back to the per-element gather path."""
    P = positions.shape[0]
    pad = (-P) % WORD_W
    if pad == 0:
        return positions
    import numpy as _np

    if isinstance(positions, _np.ndarray):
        return _np.concatenate(
            [positions, _np.zeros((pad,), positions.dtype)]
        )
    return jnp.concatenate(
        [positions, jnp.zeros((pad,), positions.dtype)]
    )


def _compact_hits(
    km, ok, offsets, positions, max_freq,
    *, fanout_cap, hit_cap, table_split=0, packed_offsets=False, payload=None,
    word_cap=0,
):
    """Compact the ragged CSR fan-out of a kmer batch into [B, H] hit slots.

    With table_split > 0, `offsets` holds TWO concatenated CSR offset tables
    (bisulfite: CT-collapsed for the forward pass, GA-collapsed for the rc
    pass, second table pre-shifted into the shared positions array); kmer
    slots >= table_split look up the second table.

    word_cap > 0 enables the WORD-GATHER path: instead of the [B, H]
    element gather from `positions`, positions are fetched as [B, HW] rows of
    WORD_W=8 (each CSR row spans ceil(cnt/8)+straddle words; HW = word_cap
    is the per-read word budget, sized from index density like hit_cap),
    then compacted back to the SAME [B, H] hit-slot layout with a dense
    one-hot select — votes/threshold/selection downstream are untouched and
    the result is bit-identical whenever no word overflow occurs (overflow
    is counted in hit_overflow).  Requires len(positions) % 8 == 0
    (pad_positions8) and the dense ownership regime (H <= _DENSE_H_MAX).

    Returns (pos [B, H] genome positions, qid [B, H] owning kmer slot,
    valid [B, H], fanout_overflow, hit_overflow).
    """
    B, Qt = km.shape
    K = fanout_cap
    H = hit_cap

    kmw = jnp.where(ok, km, 0)
    if table_split:
        # INTERLEAVED layout (candidate_search_dual): odd k-mer columns are
        # the rc pass and look up the second table.  Interleaving makes the
        # H-cap truncation strand-FAIR: with the tables laid out
        # [fwd | rc], an overflowing read lost its entire rc pass (slots
        # fill in column order), which silently unmapped reverse bisulfite
        # reads at dense-collapsed-row scales (round-3 bug).
        stride = offsets.shape[0] // 2
        sel = (
            jax.lax.broadcasted_iota(jnp.int32, (1, Qt), 1) & 1
        ).astype(jnp.int32)
        kmw = kmw + sel * stride
    if packed_offsets:
        # ONE gather: offsets is the uint32 (o0 << 6 | len) table from
        # pack_offsets (repeat masking already baked in)
        pw = offsets[kmw]                    # [B, Qt] uint32
        o0 = (pw >> PACK_CNT_BITS).astype(jnp.int32)
        cnt = jnp.where(ok, (pw & ((1 << PACK_CNT_BITS) - 1)).astype(jnp.int32), 0)
    else:
        o0 = offsets[kmw]                    # [B, Qt]
        o1 = offsets[kmw + 1]
        cnt = jnp.where(ok, o1 - o0, 0)
        cnt = jnp.where(cnt > max_freq, 0, cnt)  # repeat masking (lookup-time)
    fanout_overflow = jnp.sum((cnt > K).astype(jnp.int32))
    cnt_c = jnp.minimum(cnt, K)

    cum = jnp.cumsum(cnt_c, axis=1) - cnt_c  # exclusive prefix sum [B, Qt]
    total = cum[:, -1] + cnt_c[:, -1]        # [B]
    hit_overflow = jnp.sum((total > H).astype(jnp.int32))
    harange = jax.lax.broadcasted_iota(jnp.int32, (B, H), 1)

    use_words = (
        word_cap > 0
        and positions.shape[0] % WORD_W == 0
        and _OWNERS_MODE in ("auto", "dense")
        and H <= _DENSE_H_MAX
    )
    if not use_words:
        # slot h belongs to the last kmer q with cum[q] <= h
        qid, pidx, pay_at = _slot_owners(cum, o0, payload, H, cnt_c)
        valid = harange < jnp.minimum(total, H)[:, None]
        pos = positions[jnp.where(valid, pidx, 0)]       # [B, H] — the ONE gather
    else:
        HW = word_cap
        # per-kmer word span in the [P/8, 8] row view of positions
        w0 = o0 >> 3
        wlast = (o0 + jnp.maximum(cnt_c, 1) - 1) >> 3
        wcnt = jnp.where(cnt_c > 0, wlast - w0 + 1, 0)   # <= cnt/8 + 1
        cumw = jnp.cumsum(wcnt, axis=1) - wcnt           # [B, Qt]
        totalw = cumw[:, -1] + wcnt[:, -1]
        word_overflow = jnp.sum((totalw > HW).astype(jnp.int32))
        # word-slot ownership: the 2-pass dense2 variant — only widx is
        # consumed, so the classic dense's extra one-hot sums are waste
        _, widx, _ = _slot_owners_dense2(cumw, w0, None, HW)
        warange = jax.lax.broadcasted_iota(jnp.int32, (B, HW), 1)
        wvalid = warange < jnp.minimum(totalw, HW)[:, None]
        pos2d = positions.reshape(-1, WORD_W)
        words = pos2d[jnp.where(wvalid, widx, 0)]        # [B, HW, 8] row gather
        # hit-slot ownership with ONE extra payload: dw = cumw - w0 gives the
        # hit's word slot as ws = dw_at + (pidx >> 3) in a single one-hot sum
        qid, pidx, pay_at, (dw_at,) = _slot_owners_dense(
            cum, o0, payload, H, extras=(cumw - w0,)
        )
        ws = dw_at + (pidx >> 3)                         # hit's word slot
        lane = pidx & (WORD_W - 1)
        valid = harange < jnp.minimum(total, H)[:, None]
        # hits whose word fell past the word budget carry garbage: drop them
        # (counted via word_overflow below)
        valid &= ws < HW
        # compaction [B, HW, 8] words -> [B, H] hit slots as an int-exact
        # einsum: positions split into bytes (0..255 — exact in bf16, the
        # ops/kmer.py trick), one-hot sel rows have a single 1 so every f32
        # accumulation is one product (replaces an 8-pass select).
        wsc = jnp.where(valid, ws, 0)
        sel = (wsc[:, :, None] == warange[:, None, :]).astype(jnp.bfloat16)
        wbytes = jax.lax.bitcast_convert_type(words, jnp.uint8)
        wbytes = wbytes.reshape(B, HW, WORD_W * 4).astype(jnp.bfloat16)
        ob = jnp.einsum(
            "bhw,bwc->bhc", sel, wbytes, preferred_element_type=jnp.float32
        ).astype(jnp.int32).reshape(B, H, WORD_W, 4)
        # recombine little-endian bytes; positions are non-negative int32 so
        # the top byte is < 128 and the shift cannot overflow
        word_vals = (ob[..., 0] | (ob[..., 1] << 8)
                     | (ob[..., 2] << 16) | (ob[..., 3] << 24))  # [B, H, 8]
        lane1h = lane[:, :, None] == jax.lax.broadcasted_iota(
            jnp.int32, (B, H, WORD_W), 2
        )
        pos = jnp.sum(jnp.where(lane1h, word_vals, 0), axis=2)
        hit_overflow = hit_overflow + word_overflow
    if payload is None:
        return pos, qid, valid, fanout_overflow, hit_overflow
    return pos, qid, valid, fanout_overflow, hit_overflow, pay_at


def _select_candidates(votes, sensitivity, max_cmrs, axis_name, best_floor=None):
    """Sort tagged votes, run-length count, threshold, stable top-C.

    `votes` carry a provenance LSB: direct votes are 2*v+1, pair-merge
    (bucket-below) votes are 2*v.  Buckets are runs of v = vote >> 1; within
    a run direct votes sort LAST, so the run-end element is direct iff the
    bucket has ANY direct hit.  Pure-phantom buckets (only merge votes) are
    suppressed — their corridor is a subset of their successor's, so they
    would only burn a candidate slot.
    """
    B, N = votes.shape
    C = max_cmrs
    s = jnp.sort(votes, axis=-1)
    sb = s >> 1                                  # bucket id per element
    ar = jax.lax.broadcasted_iota(jnp.int32, (B, N), 1)
    prev = jnp.concatenate([jnp.full((B, 1), -1, jnp.int32), sb[:, :-1]], axis=1)
    nxt = jnp.concatenate(
        [sb[:, 1:], jnp.full((B, 1), SENTINEL, jnp.int32)], axis=1
    )
    is_start = sb != prev
    is_end = sb != nxt
    start_idx = _cummax(jnp.where(is_start, ar, 0), axis=1)
    # run length at run ENDS: only one FORWARD scan needed; run-end indices
    # are ascending in vote value so stable top_k still tie-breaks by
    # (strand asc, bucket asc) per DESIGN.md rules 6/7
    key = jnp.where(
        is_end & (sb != SENTINEL >> 1) & ((s & 1) == 1),
        ar - start_idx + 1,
        0,
    )

    best = jnp.max(key, axis=1)
    # under index sharding the adaptive threshold must be relative to the
    # GLOBAL best bucket score, or shard count changes the candidate set
    # (DESIGN.md rule 15); axis_name names the index-shard mesh axis.
    # best_floor [B] is the sequential-shard-loop equivalent: the caller's
    # precomputed cross-shard best (models/mapper.py::cs_best_step)
    best_thr = jax.lax.pmax(best, axis_name) if axis_name else best
    if best_floor is not None:
        best_thr = jnp.maximum(best_thr, best_floor)
    thresh = jnp.maximum(
        1, jnp.ceil(best_thr.astype(jnp.float32) * sensitivity)
    ).astype(jnp.int32)
    eligible = key >= thresh[:, None]
    n_cands = jnp.sum(eligible, axis=1)
    cmr_overflow = jnp.sum((n_cands > C).astype(jnp.int32))

    sel_key = jnp.where(eligible, key, 0)
    # C+1: the extra column is the (C+1)-th best eligible score, kept so a
    # floorless phase-1 selection (sequential shard loop) can later count
    # overflow exactly against the GLOBAL threshold
    if C + 1 <= N:
        top_score1, top_idx1 = jax.lax.top_k(sel_key, C + 1)
        top_score, top_idx = top_score1[:, :C], top_idx1[:, :C]
        extra_score = top_score1[:, C]
    else:  # C covers every vote slot: nothing can ever be clipped
        top_score, top_idx = jax.lax.top_k(sel_key, C)
        extra_score = jnp.zeros((B,), jnp.int32)
    top_vote = jnp.take_along_axis(s, top_idx, axis=1)   # [B, C] small gather
    # best_thr (not the local best) is returned so downstream gates — the
    # --kmer-min zero-CMR retry — see the GLOBAL best under index sharding;
    # a local-only gate would make output depend on shard count
    # (DESIGN.md rule 15).  Without axis/floor, best_thr == best.
    return top_vote, top_score, best_thr, cmr_overflow, extra_score


@partial(
    jax.jit,
    static_argnames=(
        "fanout_cap", "hit_cap", "max_cmrs", "diag_bin_log2", "stride",
        "dual_tables", "axis_name", "packed_offsets", "word_cap",
    ),
)
def candidate_search_dual(
    km_f: jax.Array,         # [B, Q] int32 forward-strand k-mers
    ok_f: jax.Array,         # [B, Q] bool
    km_r: jax.Array,         # [B, Q] int32 reverse-complement-strand k-mers
    ok_r: jax.Array,         # [B, Q] bool
    offsets: jax.Array,      # [4^k + 1 (+1)] int32 CSR offsets (device)
    positions: jax.Array,    # [P] int32 genome positions (device)
    sensitivity: jax.Array,  # scalar float32
    max_freq: jax.Array,     # scalar int32 repeat mask
    best_floor: jax.Array | None = None,  # [B] cross-shard best-count floor
    *,
    fanout_cap: int,
    hit_cap: int,
    max_cmrs: int,
    diag_bin_log2: int,
    stride: int = 1,
    dual_tables: bool = False,
    axis_name: str | None = None,
    packed_offsets: bool = False,
    word_cap: int = 0,
) -> Candidates:
    """Both strands in ONE counting pass (like the reference's CS table).

    The adaptive threshold is relative to the best region across both
    strands; candidate order is score DESC, strand asc (fwd first),
    bucket asc.  With dual_tables (bisulfite), the rc-strand kmers look up
    the second (GA-collapsed) CSR table in the concatenated `offsets`.
    """
    B, Q = km_f.shape
    # INTERLEAVE the strands (even cols fwd, odd cols rc) so the H-cap
    # truncates both passes evenly — a [fwd | rc] concat dropped the whole
    # rc pass of an overflowing read (slots fill in column order)
    km = jnp.stack([km_f, km_r], axis=2).reshape(B, 2 * Q)
    ok = jnp.stack([ok_f, ok_r], axis=2).reshape(B, 2 * Q)

    pos, qid, valid, fo, ho = _compact_hits(
        km, ok, offsets, positions, max_freq,
        fanout_cap=fanout_cap, hit_cap=hit_cap,
        table_split=Q if dual_tables else 0,
        packed_offsets=packed_offsets, word_cap=word_cap,
    )
    strand = qid & 1                                     # [B, H]
    qoff = (qid >> 1) * stride
    diag = pos - qoff
    bucket = diag >> diag_bin_log2
    vote = strand * _STRAND_OFF + bucket + _BIAS

    # double-vote: a hit in bucket b votes for b (direct, LSB=1) AND b−1
    # (merge vote, LSB=0), so the vote count of b is hits(b) + hits(b+1) —
    # the adjacent-bin pair merge — and pure-phantom buckets are detectable
    vote_hi = jnp.where(valid, 2 * vote + 1, SENTINEL)
    vote_lo = jnp.where(valid, 2 * (vote - 1), SENTINEL)
    votes = jnp.concatenate([vote_hi, vote_lo], axis=1)  # [B, 2H]

    top_vote, top_score, best, co, extra = _select_candidates(
        votes, sensitivity, max_cmrs, axis_name, best_floor
    )
    got = top_score > 0
    top_vote = top_vote >> 1
    top_strand = jnp.where(got, top_vote // _STRAND_OFF, 0)
    top_bucket = jnp.where(
        got, top_vote - top_strand * _STRAND_OFF - _BIAS, SENTINEL
    )
    return Candidates(
        bucket=top_bucket,
        score=top_score,
        strand=top_strand,
        best_score=best,
        fanout_overflow=fo,
        hit_overflow=ho,
        cmr_overflow=co,
        extra_score=extra,
    )


@partial(
    jax.jit,
    static_argnames=(
        "k", "fanout_cap", "hit_cap", "max_cmrs", "diag_bin_log2", "stride",
        "axis_name", "packed_offsets", "word_cap",
    ),
)
def candidate_search_canonical(
    canon: jax.Array,        # [B, Q] int32 canonical k-mers of the FWD read
    flip: jax.Array,         # [B, Q] int32 1 where the read k-mer was flipped
    ok: jax.Array,           # [B, Q] bool
    lengths: jax.Array,      # [B] int32
    offsets: jax.Array,
    positions: jax.Array,    # [P] int32 (pos << 1 | genome-flip) entries
    sensitivity: jax.Array,
    max_freq: jax.Array,
    best_floor: jax.Array | None = None,  # [B] cross-shard best-count floor
    *,
    k: int,
    fanout_cap: int,
    hit_cap: int,
    max_cmrs: int,
    diag_bin_log2: int,
    stride: int = 1,
    axis_name: str | None = None,
    packed_offsets: bool = False,
    word_cap: int = 0,
) -> Candidates:
    """Both strands from ONE canonical lookup per read k-mer.

    The index stores (pos << 1 | flip) under min(kmer, revcomp(kmer))
    (index/device_build.py canonical=True).  A hit's strand is
    read-flip XOR stored-flip; the reverse-strand diagonal uses the k-mer's
    offset in the REVERSE-COMPLEMENTED read, len - k - offset — the same
    diagonal space as the two-strand search.  Ordering/threshold semantics
    are identical to candidate_search_dual.
    """
    B, Q = canon.shape
    out = _compact_hits(
        canon, ok, offsets, positions, max_freq,
        fanout_cap=fanout_cap, hit_cap=hit_cap,
        packed_offsets=packed_offsets, payload=flip, word_cap=word_cap,
    )
    pos_e, qid, valid, fo, ho, yflip = out
    p = pos_e >> 1
    gflip = pos_e & 1
    strand = yflip ^ gflip                               # [B, H]
    qoff = qid * stride
    rc_off = lengths[:, None] - k - qoff
    diag = jnp.where(strand == 0, p - qoff, p - rc_off)
    bucket = diag >> diag_bin_log2
    vote = strand * _STRAND_OFF + bucket + _BIAS

    vote_hi = jnp.where(valid, 2 * vote + 1, SENTINEL)
    vote_lo = jnp.where(valid, 2 * (vote - 1), SENTINEL)
    votes = jnp.concatenate([vote_hi, vote_lo], axis=1)  # [B, 2H]

    top_vote, top_score, best, co, extra = _select_candidates(
        votes, sensitivity, max_cmrs, axis_name, best_floor
    )
    got = top_score > 0
    top_vote = top_vote >> 1
    top_strand = jnp.where(got, top_vote // _STRAND_OFF, 0)
    top_bucket = jnp.where(
        got, top_vote - top_strand * _STRAND_OFF - _BIAS, SENTINEL
    )
    return Candidates(
        bucket=top_bucket,
        score=top_score,
        strand=top_strand,
        best_score=best,
        fanout_overflow=fo,
        hit_overflow=ho,
        cmr_overflow=co,
        extra_score=extra,
    )


@partial(
    jax.jit,
    static_argnames=(
        "fanout_cap", "hit_cap", "max_cmrs", "diag_bin_log2", "stride", "axis_name"
    ),
)
def candidate_search(
    kmers: jax.Array,
    kvalid: jax.Array,
    offsets: jax.Array,
    positions: jax.Array,
    sensitivity: jax.Array,
    max_freq: jax.Array,
    *,
    fanout_cap: int,
    hit_cap: int = 0,
    max_cmrs: int,
    diag_bin_log2: int,
    stride: int = 1,
    axis_name: str | None = None,
) -> Candidates:
    """Single-strand candidate search (unit-test surface; mapper uses dual)."""
    B, Q = kmers.shape
    H = hit_cap or 2 * Q
    pos, qid, valid, fo, ho = _compact_hits(
        kmers, kvalid, offsets, positions, max_freq,
        fanout_cap=fanout_cap, hit_cap=H,
    )
    diag = pos - qid * stride
    bucket = diag >> diag_bin_log2
    vote = bucket + _BIAS
    vote_hi = jnp.where(valid, 2 * vote + 1, SENTINEL)
    vote_lo = jnp.where(valid, 2 * (vote - 1), SENTINEL)
    votes = jnp.concatenate([vote_hi, vote_lo], axis=1)

    top_vote, top_score, best, co, extra = _select_candidates(
        votes, sensitivity, max_cmrs, axis_name
    )
    got = top_score > 0
    top_bucket = jnp.where(got, (top_vote >> 1) - _BIAS, SENTINEL)
    return Candidates(
        bucket=top_bucket,
        score=top_score,
        strand=jnp.zeros_like(top_bucket),
        best_score=best,
        fanout_overflow=fo,
        hit_overflow=ho,
        cmr_overflow=co,
        extra_score=extra,
    )


def merge_strand_candidates(fwd: Candidates, rev: Candidates, max_cmrs: int):
    """Merge two single-strand candidate lists under DESIGN.md rule 7.

    Kept for unit tests and API parity; the mapper uses
    candidate_search_dual, which applies the same ordering in one pass.
    """
    C = max_cmrs
    bucket = jnp.concatenate([fwd.bucket, rev.bucket], axis=1)
    score = jnp.concatenate([fwd.score, rev.score], axis=1)
    strand = jnp.concatenate(
        [jnp.zeros_like(fwd.score), jnp.ones_like(rev.score)], axis=1
    )
    top_score, idx = jax.lax.top_k(score, C)
    top_bucket = jnp.take_along_axis(bucket, idx, axis=1)
    top_strand = jnp.take_along_axis(strand, idx, axis=1)
    top_bucket = jnp.where(top_score > 0, top_bucket, SENTINEL)
    top_strand = jnp.where(top_score > 0, top_strand, 0)
    return top_bucket, top_score, top_strand
