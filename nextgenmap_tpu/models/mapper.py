"""The flagship model: one jitted end-to-end mapping step (single or paired).

Reference analog: the whole per-read hot path of SURVEY.md §3.2 — CS task ->
ScoreBuffer/BatchScore -> top-n -> AlignmentBuffer/BatchAlign -> filters —
which the reference spreads over pthread workers and device batch buffers
(ref:src/CS.cpp, ref:src/ScoreBuffer.cpp, ref:src/AlignmentBuffer.cpp), plus
the paired-end resolution that lives inside ScoreBuffer (SURVEY.md §2
component 21: insert-size window + orientation + combined score, with
broken-pair fallback).

Accelerator shape (SURVEY.md §7 design stance): the stages are fused into ONE
bulk-synchronous jitted step over a `[B, L]` read batch:

  rc -> candidate search (both strands) -> corridor gather ->
  banded-SW score over all candidates -> deterministic selection
  (single-end argmax, or paired CxC insert-window argmax) ->
  banded-SW traceback on the winner -> filters + MAPQ

All shapes are static (caps + masks); overflow counters come back with the
results.  `map_step` / `map_step_paired` are what `__graft_entry__.entry()`
exposes and what `parallel/` shards over a device mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from nextgenmap_tpu.config import NgmConfig
from nextgenmap_tpu.index.genome import Genome
from nextgenmap_tpu.index.kmer_index import KmerIndex
from nextgenmap_tpu.ops.candidate import (
    candidate_search_canonical, candidate_search_dual,
)
from nextgenmap_tpu.ops.gather import (
    gather_windows, pad_table, permute_small, take_rows_mxu,
)
from nextgenmap_tpu.ops.kmer import extract_kmers, extract_kmers_canonical
from nextgenmap_tpu.ops.scoring import score_matrix
from nextgenmap_tpu.ops.sw_ref import banded_sw_align, banded_sw_score


class MapResult(NamedTuple):
    """Per-read mapping outcome (all arrays [B] unless noted)."""

    mapped: jax.Array      # bool
    strand: jax.Array      # int32 0 fwd / 1 rev
    pos: jax.Array         # int32 absolute genome position of first aligned base
    mapq: jax.Array        # int32 0..60
    score: jax.Array       # int32 best SW score
    second: jax.Array      # int32 second-best (different locus) SW score
    q_start: jax.Array     # int32 first aligned base in ALIGNED orientation
    q_end: jax.Array       # int32 last aligned base (inclusive)
    ops: jax.Array         # [B, MO] uint8 traceback ops END->START
    n_ops: jax.Array       # int32
    matches: jax.Array     # int32
    mismatches: jax.Array  # int32
    indels: jax.Array      # int32
    n_candidates: jax.Array  # int32 CMRs scored for this read
    proper: jax.Array      # bool — paired runs only (False for single-end)
    fanout_overflow: jax.Array  # [] int32
    cmr_overflow: jax.Array     # [] int32


def revcomp_batch(codes: jax.Array) -> jax.Array:
    """[B, L] reverse complement on device (PAD rows stay PAD)."""
    flipped = codes[:, ::-1].astype(jnp.int32)
    return jnp.where(flipped < 4, 3 - flipped, flipped).astype(codes.dtype)


def _pre_extract(reads, lengths, *, k, read_stride=1, bs=False, bs_cutoff=0,
                 canonical=False):
    """Read-only CS inputs (shifted rc + k-mer windows) — independent of the
    index tables, so the sequential shard loop computes them ONCE and feeds
    every shard's CS pass (S-1 redundant extractions removed)."""
    B, L = reads.shape
    rc = revcomp_batch(reads)
    # the rc flip moves right-padding to the front for reads shorter than L;
    # shift each rc row left by (L - length) so rc reads start at column 0
    shift = (L - lengths)[:, None]
    idx = jnp.arange(L)[None, :] + shift
    rc = jnp.take_along_axis(
        jnp.pad(rc, ((0, 0), (0, L)), constant_values=4), idx, axis=1
    )
    if canonical and not bs:
        kms = extract_kmers_canonical(reads, lengths, k, stride=read_stride)
    else:
        # bisulfite (SURVEY.md §2 component 22): the fwd pass is C->T
        # tolerant (read and index CT-collapsed); the rc pass is G->A
        # tolerant (the rc of an original-bottom-strand read shows G->A vs
        # the fwd genome) and looks up the second, GA-collapsed CSR table
        km_f, ok_f = extract_kmers(
            reads, lengths, k, stride=read_stride,
            collapse="ct" if bs else "none",
            max_collapsed=bs_cutoff if bs else 0,
        )
        km_r, ok_r = extract_kmers(
            rc, lengths, k, stride=read_stride,
            collapse="ga" if bs else "none",
            max_collapsed=bs_cutoff if bs else 0,
        )
        kms = (km_f, ok_f, km_r, ok_r)
    return rc, kms


def _candidates(
    genome, offsets, positions, reads, lengths, sensitivity, max_freq,
    best_floor=None, pre=None,
    *, k, fanout_cap, hit_cap, max_cmrs, diag_bin_log2, band, min_kmer_hits,
    read_stride=1, bs=False, bs_cutoff=0, cs_axis=None, packed_offsets=False,
    canonical=False, word_cap=0,
):
    """CS on both strands -> deterministically ordered candidate grid.

    Candidate arrays are REORDERED by (strand asc, corridor start asc) so
    later argmax/top_k selections tie-break per DESIGN.md rule 11; valid
    candidates form a per-read PREFIX after the ordering.  Returns
    (corr_start [B,C], strand [B,C], cand_valid [B,C], cs_score [B,C] the
    bucket hit counts (0 where below the local threshold), n_cands [B],
    rc [B,L] the left-shifted reverse-complement batch, best [B] best
    bucket hit count, overflow pair).  best_floor (optional [B]) raises the
    adaptive threshold to a cross-shard best computed outside (the
    sequential index-shard loop's analog of the mesh path's pmax).
    `pre` (optional) is the precomputed (rc, kmer arrays) tuple from
    _pre_extract: the sequential shard scan extracts ONCE and reuses it for
    every shard (reads are loop-invariant; only the tables change).
    """
    B, L = reads.shape
    W = band
    T = L + W
    G = genome.shape[0]
    bin_w = 1 << diag_bin_log2

    if pre is None:
        pre = _pre_extract(
            reads, lengths, k=k, read_stride=read_stride, bs=bs,
            bs_cutoff=bs_cutoff, canonical=canonical,
        )
    rc, kms = pre
    if canonical and not bs:
        # ONE canonical lookup per window covers both strands — halves the
        # offset-table gathers of the candidate search
        canon, flip, ok_c = kms
        cand = candidate_search_canonical(
            canon, flip, ok_c, lengths, offsets, positions,
            sensitivity, max_freq, best_floor,
            k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
            diag_bin_log2=diag_bin_log2, stride=read_stride,
            axis_name=cs_axis, packed_offsets=packed_offsets,
            word_cap=word_cap,
        )
    else:
        km_f, ok_f, km_r, ok_r = kms
        cand = candidate_search_dual(
            km_f, ok_f, km_r, ok_r, offsets, positions, sensitivity, max_freq,
            best_floor,
            fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
            diag_bin_log2=diag_bin_log2, stride=read_stride, dual_tables=bs,
            axis_name=cs_axis, packed_offsets=packed_offsets,
            word_cap=word_cap,
        )
    bucket, cs_score, strand = cand.bucket, cand.score, cand.strand
    cand_valid = cs_score >= max(1, min_kmer_hits)
    if min_kmer_hits > 1:
        # zero-CMR retry (ref:src/CS.cpp CollectResults fallback): a read
        # whose every bucket falls below kmer_min gets a second chance at
        # threshold 1 instead of silently dropping — one masked select, no
        # second search pass.  The gate is the GLOBALIZED best bucket count
        # (pmax over the ish axis / the sequential loop's best_floor), so
        # under index sharding every shard takes the same branch — a
        # local-only gate would let a weak shard's retry candidate win the
        # merge while the unsharded run never generates it.
        none = cand.best_score < min_kmer_hits
        cand_valid = jnp.where(none[:, None], cs_score >= 1, cand_valid)

    # deterministic candidate order: (strand asc, corridor start asc)
    slack = (W - 2 * bin_w) // 2
    corr_start = jnp.where(
        cand_valid, (bucket << diag_bin_log2) - slack, 0
    ).astype(jnp.int32)
    corr_start = jnp.clip(corr_start, 0, max(0, G - T))
    order_key = jnp.where(
        cand_valid, strand * (2**30) + corr_start, 2**31 - 1
    )
    order = jnp.argsort(order_key, axis=1)
    corr_start = permute_small(corr_start, order)
    strand = permute_small(strand, order)
    cs_score = permute_small(cs_score, order)
    cand_valid = permute_small(cand_valid.astype(jnp.int32), order) == 1

    n_cands = jnp.sum(cand_valid.astype(jnp.int32), axis=1)   # [B]
    overflow = (
        cand.fanout_overflow + cand.hit_overflow,
        cand.cmr_overflow,
    )
    return (corr_start, strand, cand_valid, cs_score, n_cands, rc,
            cand.best_score, overflow, cand.extra_score)


def _score_candidates(
    genome, reads, rc, lengths, corr_start, strand, cand_valid, score_mask,
    matrices, gopen_q, gopen_r, gext,
    *, band, slot_cap, end_to_end=False,
    simple_matrix=False,
):
    """Banded-SW score the candidates of reads selected by `score_mask`.

    LAZY SCORING (the big round-1 perf lever): a read whose selection needs
    no comparison — one candidate, or a single-candidate pair — skips the
    score pass entirely; its winner's score comes bit-identically from the
    traceback DP in _finish.  On a 2%-SNP E. coli batch, 100% of reads have
    exactly one candidate, so this removes the whole BatchScore stage that
    the reference always pays (ref:src/ScoreBuffer.cpp).

    (read, candidate) pairs of masked reads are COMPACTED batch-wide into
    `slot_cap` flat slots (DESIGN.md rule 8b): corridors are window-gathered
    and scored once per REAL candidate, and the scores scattered back to a
    dense [B, C] grid (0 where unscored) for the selection argmax/top_k.
    """
    B, L = reads.shape
    C = corr_start.shape[1]
    W = band
    T = L + W

    eff_valid = cand_valid & score_mask[:, None]
    n_sc = jnp.sum(eff_valid.astype(jnp.int32), axis=1)       # [B]
    base = jnp.cumsum(n_sc) - n_sc                            # exclusive [B]
    total = base[-1] + n_sc[-1]
    S = slot_cap
    slot_overflow = (total > S).astype(jnp.int32)

    # slot s belongs to the last read b with base[b] <= s
    sar = jax.lax.broadcasted_iota(jnp.int32, (S, 1), 0)[:, 0]
    ge = sar[:, None] >= base[None, :]                        # [S, B]
    b_of = jnp.sum(ge.astype(jnp.int32), axis=1) - 1          # [S]
    slot_valid = sar < jnp.minimum(total, S)
    onehot_b = jax.lax.broadcasted_iota(jnp.int32, (S, B), 1) == b_of[:, None]
    base_at = jnp.sum(jnp.where(onehot_b, base[None, :], 0), axis=1)
    j_of = sar - base_at                                      # candidate index
    flat_idx = jnp.where(slot_valid, b_of * C + j_of, 0)

    corr_start_s = corr_start.reshape(-1)[flat_idx]           # [S] small gathers
    strand_s = strand.reshape(-1)[flat_idx]
    len_s = lengths[jnp.where(slot_valid, b_of, 0)]

    # corridor gather (ref: SequenceProvider corridor extraction) — one
    # contiguous window per REAL candidate
    corr_starts = jnp.where(slot_valid, corr_start_s, 0)
    q2 = jnp.concatenate([reads, rc], axis=0)                 # [2B, L]
    qrow = strand_s * B + jnp.where(slot_valid, b_of, 0)
    corr_s = gather_windows(pad_table(genome, T, 4), corr_starts, T)
    # slot query rows: one one-hot matmul instead of per-row gathers
    q_s = take_rows_mxu(q2, qrow)
    corr_s = jnp.where(slot_valid[:, None], corr_s, 4)        # [S, T]

    # score every compacted candidate (ref: IAlignment::BatchScore)
    sres = banded_sw_score(
        q_s, len_s, corr_s, matrices,
        gopen_q, gopen_r, gext, strand_s,
        band=W, mode="glocal" if end_to_end else "local",
        simple=simple_matrix,
    )
    score_s = jnp.where(slot_valid, sres.score, 0)

    # scatter scores back to the dense [B, C] candidate grid for selection
    sw = (
        jnp.zeros((B * C + 1,), jnp.int32)
        .at[jnp.where(slot_valid, flat_idx, B * C)]
        .set(score_s)[: B * C]
        .reshape(B, C)
    )
    sw = jnp.where(eff_valid, sw, 0)
    return sw, slot_overflow


def _finish(
    a1, sw, corr_start, strand, cand_valid, genome, reads, rc, lengths,
    matrices, gopen_q, gopen_r, gext, min_identity, min_residues,
    n_cands, overflow, proper, *, band, end_to_end=False,
    simple_matrix=False,
):
    """Traceback the chosen candidate a1 [B] and apply filters + MAPQ.

    The winner's corridor is re-fetched from the genome (one window per
    read — same cost as re-reading a slot array, but independent of the
    lazy-scoring slot set).  The result score is the traceback DP's score:
    bit-identical to the score kernel for scored candidates, and the ONLY
    score ever computed for lazily-unscored single-candidate reads.
    """
    B, C = sw.shape
    L = reads.shape[1]
    T = L + band
    G = genome.shape[0]

    a1_valid = jnp.take_along_axis(cand_valid, a1[:, None], axis=1)[:, 0]
    best_start = jnp.take_along_axis(corr_start, a1[:, None], axis=1)[:, 0]
    best_strand = jnp.take_along_axis(strand, a1[:, None], axis=1)[:, 0]
    # second best at a DIFFERENT locus (outside ±L of the winner) for MAPQ;
    # the grid holds 0 for lazily-unscored reads, which have no second locus
    far = jnp.abs(corr_start - best_start[:, None]) > L
    s2 = jnp.max(jnp.where(far, sw, 0), axis=1)

    starts = jnp.clip(jnp.where(a1_valid, best_start, 0), 0, max(0, G - T))
    best_corr = gather_windows(pad_table(genome, T, 4), starts, T)
    # winner query row is row-aligned in (reads | rc): a select, not a gather
    best_query = jnp.where((best_strand == 1)[:, None], rc, reads)
    ares = banded_sw_align(
        best_query, lengths, best_corr, matrices,
        gopen_q, gopen_r, gext, best_strand,
        band=band, mode="glocal" if end_to_end else "local",
        simple=simple_matrix,
    )
    s1 = jnp.where(a1_valid, ares.score, 0)

    aln_cols = jnp.maximum(1, ares.n_ops)
    identity = ares.matches.astype(jnp.float32) / aln_cols.astype(jnp.float32)
    residues = (ares.q_end - ares.q_start + 1).astype(jnp.float32)
    min_res_abs = min_residues * lengths.astype(jnp.float32)
    mapped = (
        (s1 > 0)
        & (lengths > 0)
        & (identity >= min_identity)
        & (residues >= min_res_abs)
        # an op-buffer overflow means the CIGAR is incomplete — never emit
        # it as an alignment; the count rides the cmr_overflow audit counter
        & ~ares.trunc
    )
    overflow = (overflow[0], overflow[1] + jnp.sum(ares.trunc.astype(jnp.int32)))
    s1f = jnp.maximum(1, s1).astype(jnp.float32)
    mapq = jnp.clip(
        jnp.round(60.0 * (s1 - s2).astype(jnp.float32) / s1f), 0, 60
    ).astype(jnp.int32)
    mapq = jnp.where(mapped, mapq, 0)
    pos_abs = best_start + ares.r_start

    return MapResult(
        mapped=mapped,
        strand=best_strand,
        pos=pos_abs,  # raw even when filtered-unmapped; consumers gate on `mapped`
        mapq=mapq,
        score=s1,
        second=s2,
        q_start=ares.q_start,
        q_end=ares.q_end,
        ops=ares.ops,
        n_ops=ares.n_ops,
        matches=ares.matches,
        mismatches=ares.mismatches,
        indels=ares.indels,
        n_candidates=n_cands,
        proper=proper & mapped,
        fanout_overflow=overflow[0],
        cmr_overflow=overflow[1],
    )


_STATICS = (
    "k", "fanout_cap", "hit_cap", "max_cmrs", "diag_bin_log2", "band",
    "min_kmer_hits", "slot_cap", "read_stride", "bs", "bs_cutoff",
    "end_to_end", "cs_axis", "packed_offsets", "canonical",
    "simple_matrix", "word_cap",
)


def _single_tail(
    genome, reads, rc, lengths, matrices, gopen_q, gopen_r, gext,
    min_identity, min_residues, corr_start, strand, cand_valid, n_cands,
    overflow, *, band, slot_cap, end_to_end,
    simple_matrix=False,
):
    """Everything after candidate search for the single-end step: lazy
    scoring, rule-11 argmax selection, traceback + filters."""
    B = reads.shape[0]
    sw, slot_ovf = _score_candidates(
        genome, reads, rc, lengths, corr_start, strand, cand_valid,
        n_cands >= 2, matrices, gopen_q, gopen_r, gext,
        band=band, slot_cap=slot_cap,
        end_to_end=end_to_end, simple_matrix=simple_matrix,
    )
    overflow = (overflow[0], overflow[1] + slot_ovf)
    # first max = score DESC, fwd first, pos ASC; all-zero (lazy) rows pick
    # candidate 0 — the read's only candidate after prefix ordering
    a1 = jnp.argmax(sw, axis=1)
    proper = jnp.zeros(B, dtype=bool)
    return _finish(
        a1, sw, corr_start, strand, cand_valid, genome, reads, rc, lengths,
        matrices, gopen_q, gopen_r, gext, min_identity, min_residues,
        n_cands, overflow, proper, band=band, end_to_end=end_to_end,
        simple_matrix=simple_matrix,
    )


def _paired_tail(
    genome, reads, rc, lengths, matrices, gopen_q, gopen_r, gext,
    min_identity, min_residues, min_insert, max_insert, pair_cutoff,
    corr_start, strand, cand_valid, n_cands, overflow,
    *, band, slot_cap, diag_bin_log2, end_to_end,
    simple_matrix=False,
):
    """Everything after candidate search for the paired step: lazy scoring,
    CxC insert-window pair resolution, traceback + filters."""
    B, L = reads.shape
    C = corr_start.shape[1]
    P = B // 2
    bin_w = 1 << diag_bin_log2

    np_ = n_cands.reshape(P, 2)
    pair_multi = (np_[:, 0] >= 2) | (np_[:, 1] >= 2)
    sw, slot_ovf = _score_candidates(
        genome, reads, rc, lengths, corr_start, strand, cand_valid,
        jnp.repeat(pair_multi, 2), matrices, gopen_q, gopen_r, gext,
        band=band, slot_cap=slot_cap,
        end_to_end=end_to_end, simple_matrix=simple_matrix,
    )
    overflow = (overflow[0], overflow[1] + slot_ovf)

    s = sw.reshape(P, 2, C)
    # approximate alignment start = corridor start + slack (candidate diagonal)
    slack = (band - 2 * bin_w) // 2
    pos = (corr_start + slack).reshape(P, 2, C)
    st = strand.reshape(P, 2, C)
    exist = cand_valid.reshape(P, 2, C)

    s1m = s[:, 0, :, None]                     # [P, C, 1]
    s2m = s[:, 1, None, :]                     # [P, 1, C]
    p1 = pos[:, 0, :, None]
    p2 = pos[:, 1, None, :]
    st1 = st[:, 0, :, None]
    st2 = st[:, 1, None, :]

    # FR orientation: strands differ and the forward mate lies leftmost
    margin = 2 * bin_w
    ok_orient = st1 != st2
    fwd_left = jnp.where(st1 == 0, p1 <= p2 + margin, p2 <= p1 + margin)
    span = jnp.abs(p2 - p1) + L                 # approximate outer distance
    ok_ins = (span >= min_insert - margin) & (span <= max_insert + margin)
    geo = ok_orient & fwd_left & ok_ins & exist[:, 0, :, None] & exist[:, 1, None, :]
    valid = geo & (s1m > 0) & (s2m > 0)
    combined = jnp.where(valid, s1m + s2m, -1)  # [P, C, C]

    flat = combined.reshape(P, C * C)
    pair_best = jnp.max(flat, axis=1)
    pair_arg = jnp.argmax(flat, axis=1)         # first max: c1 ASC then c2 ASC
    c1s = pair_arg // C
    c2s = pair_arg % C

    best1 = jnp.max(s[:, 0], axis=1)
    best2 = jnp.max(s[:, 1], axis=1)
    proper_scored = (pair_best > 0) & (
        pair_best.astype(jnp.float32)
        >= pair_cutoff * (best1 + best2).astype(jnp.float32)
    )
    # single x single: the only combination is (0, 0); propriety is pure
    # geometry (final `proper` is still gated by both mates mapping)
    proper_single = geo[:, 0, 0] & (np_[:, 0] >= 1) & (np_[:, 1] >= 1)
    proper_pair = jnp.where(pair_multi, proper_scored, proper_single)
    c1 = jnp.where(pair_multi, c1s, 0)
    c2 = jnp.where(pair_multi, c2s, 0)

    a_single = jnp.argmax(sw, axis=1).reshape(P, 2)
    sel1 = jnp.where(proper_pair, c1, a_single[:, 0])
    sel2 = jnp.where(proper_pair, c2, a_single[:, 1])
    a1 = jnp.stack([sel1, sel2], axis=1).reshape(B)
    proper = jnp.repeat(proper_pair, 2)

    return _finish(
        a1, sw, corr_start, strand, cand_valid, genome, reads, rc, lengths,
        matrices, gopen_q, gopen_r, gext, min_identity, min_residues,
        n_cands, overflow, proper, band=band, end_to_end=end_to_end,
        simple_matrix=simple_matrix,
    )


@partial(jax.jit, static_argnames=_STATICS)
def map_step(
    genome, offsets, positions, reads, lengths, matrices,
    gopen_q, gopen_r, gext, sensitivity, max_freq, min_identity, min_residues,
    best_floor=None,
    *, k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, bs=False, bs_cutoff=0,
    end_to_end=False, packed_offsets=False,
    simple_matrix=False,
    canonical=False, cs_axis=None, word_cap=0,
) -> MapResult:
    """Single-end mapping step (DESIGN.md rule 11 selection).

    Lazy scoring: only reads with >= 2 candidates go through the score pass
    (their [B, C] grid rows feed the argmax); a single-candidate read's
    winner is its candidate 0 and its score comes from the traceback DP.
    """
    B = reads.shape[0]
    # lazy scoring rarely needs many slots (most reads have 1 candidate);
    # overflow is counted, so a repeat-dense genome is visible, not silent
    slot_cap = slot_cap or max(512, B // 2)
    corr_start, strand, cand_valid, _, n_cands, rc, _, overflow, _ = _candidates(
        genome, offsets, positions, reads, lengths, sensitivity, max_freq,
        best_floor,
        k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, band=band, min_kmer_hits=min_kmer_hits,
        read_stride=read_stride, bs=bs, bs_cutoff=bs_cutoff, cs_axis=cs_axis,
        packed_offsets=packed_offsets, canonical=canonical,
        word_cap=word_cap,
    )
    return _single_tail(
        genome, reads, rc, lengths, matrices, gopen_q, gopen_r, gext,
        min_identity, min_residues, corr_start, strand, cand_valid, n_cands,
        overflow, band=band, slot_cap=slot_cap,
        end_to_end=end_to_end, simple_matrix=simple_matrix,
    )


@partial(jax.jit, static_argnames=_STATICS)
def cs_best_step(
    genome, offsets, positions, reads, lengths, sensitivity, max_freq,
    *, k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, bs=False, bs_cutoff=0,
    end_to_end=False, packed_offsets=False,
    simple_matrix=False,
    canonical=False, cs_axis=None, word_cap=0,
) -> jax.Array:
    """Candidate-search-only pass returning the per-read best bucket count.

    Phase 1 of the SEQUENTIAL index-shard loop (one chip, S > devices): the
    adaptive CMR threshold must be relative to the best bucket count across
    ALL shards (DESIGN.md rule 15) — on a mesh that's a pmax over "ish"; here
    the host maxes these per-shard bests and feeds the result back into
    phase 2's map_step as `best_floor`.  XLA dead-code-eliminates the
    selection/ordering work, leaving just lookup + compaction + vote count.
    """
    *_, best, _, _ = _candidates(
        genome, offsets, positions, reads, lengths, sensitivity, max_freq,
        k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, band=band, min_kmer_hits=min_kmer_hits,
        read_stride=read_stride, bs=bs, bs_cutoff=bs_cutoff, cs_axis=cs_axis,
        packed_offsets=packed_offsets, canonical=canonical,
        word_cap=word_cap,
    )
    return best


class CandState(NamedTuple):
    """Per-shard candidate lists from ONE CS pass (sequential shard loop).

    cs_score holds the bucket hit counts of the top-C candidates under the
    LOCAL adaptive threshold; the cross-shard re-gate (map_step_*_from_cands)
    re-derives validity from these against the GLOBAL best, which is exact:
    the global threshold >= the local one, and globally eligible candidates
    are always the list's top scorers, so they are never clipped by C unless
    they would also be clipped in a one-shot global-threshold selection.
    """

    corr_start: jax.Array       # [B, C] int32
    strand: jax.Array           # [B, C] int32
    cs_score: jax.Array         # [B, C] int32
    best: jax.Array             # [B] int32 local best bucket count
    fanout_overflow: jax.Array  # [] int32
    cmr_overflow: jax.Array     # [] int32 — LOCAL-threshold count; bogus for
                                # audit (non-owning shards see a noise-level
                                # best => threshold 1 => floods); phase 2
                                # recounts with extra_score vs the GLOBAL
                                # threshold and uses that instead
    extra_score: jax.Array      # [B] int32 (C+1)-th best eligible score


@partial(jax.jit, static_argnames=_STATICS)
def cs_cands_step(
    genome, offsets, positions, reads, lengths, sensitivity, max_freq,
    pre=None,
    *, k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, bs=False, bs_cutoff=0,
    end_to_end=False, packed_offsets=False,
    simple_matrix=False,
    canonical=False, cs_axis=None, word_cap=0,
) -> CandState:
    """Phase 1 of the SINGLE-PASS sequential index-shard loop: the full CS
    once per shard, keeping the candidate lists for phase 2 instead of
    re-deriving them (round 2 ran cs_best_step + map_step = TWO full CS
    passes per shard; CS dominates the sharded step).  `pre` (optional) is
    the shared _pre_extract result when the caller loops over shards."""
    corr_start, strand, _, cs_score, _, _, best, overflow, extra = _candidates(
        genome, offsets, positions, reads, lengths, sensitivity, max_freq,
        pre=pre,
        k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, band=band, min_kmer_hits=min_kmer_hits,
        read_stride=read_stride, bs=bs, bs_cutoff=bs_cutoff, cs_axis=cs_axis,
        packed_offsets=packed_offsets, canonical=canonical,
        word_cap=word_cap,
    )
    return CandState(corr_start, strand, cs_score, best,
                     overflow[0], overflow[1], extra)


def _shifted_rc(reads, lengths):
    """Reverse-complement batch with right-padding shifted off the front."""
    B, L = reads.shape
    rc = revcomp_batch(reads)
    shift = (L - lengths)[:, None]
    idx = jnp.arange(L)[None, :] + shift
    return jnp.take_along_axis(
        jnp.pad(rc, ((0, 0), (0, L)), constant_values=4), idx, axis=1
    )


def _regate_candidates(cand: CandState, best_g, sensitivity, min_kmer_hits):
    """Re-derive candidate validity against the GLOBAL best bucket count and
    restore the valid-prefix ordering (identical keys to _candidates)."""
    thresh = jnp.maximum(
        1, jnp.ceil(best_g.astype(jnp.float32) * sensitivity)
    ).astype(jnp.int32)
    need = max(1, min_kmer_hits)
    if min_kmer_hits > 1:
        # zero-CMR retry, gated on the GLOBAL best (DESIGN.md rule 15)
        need = jnp.where(best_g < min_kmer_hits, 1, need)
        thresh = jnp.maximum(thresh, need)
    valid = cand.cs_score >= thresh[:, None]
    order_key = jnp.where(
        valid, cand.strand * (2**30) + cand.corr_start, 2**31 - 1
    )
    order = jnp.argsort(order_key, axis=1)
    corr_start = permute_small(cand.corr_start, order)
    strand = permute_small(cand.strand, order)
    valid = permute_small(valid.astype(jnp.int32), order) == 1
    n_cands = jnp.sum(valid.astype(jnp.int32), axis=1)
    # HONEST cmr overflow for the floorless phase 1: a read lost an eligible
    # candidate to the C-truncation iff the (C+1)-th best local score still
    # clears the GLOBAL threshold (exact: eligibility is purely score >= thr)
    cmr_overflow = jnp.sum((cand.extra_score >= thresh).astype(jnp.int32))
    return corr_start, strand, valid, n_cands, cmr_overflow


def _compacted_shard_tail(
    genome, reads, rc, lengths, matrices, gopen_q, gopen_r, gext,
    min_identity, min_residues, corr_start, strand, cand_valid, n_cands,
    overflow, pair_args=None, *, band, slot_cap, diag_bin_log2,
    end_to_end, simple_matrix, compact_cap,
):
    """Post-CS tail over ONLY the reads that have candidates in this shard.

    In the sequential index-shard loop, a shard's re-gated candidate lists
    are empty for ~ (S-1)/S of the batch, yet the tail's static [B] shapes —
    the score-slot compaction, the winner traceback DP, the paired CxC
    resolution — pay for every read, S times over the loop (VERDICT r2
    missing #6: ~8x device work per read at S=4).  Here reads (PAIRS in
    paired mode — pair resolution needs both mates' rows in the shard where
    either has work) with n_cands > 0 are compacted into `compact_cap` rows,
    the ordinary tail runs on the small batch, and per-read results scatter
    back to [B]; rows a shard has no candidates for return zeroed fields,
    which the cross-shard merge never selects (ownership requires
    score > 0).  Reads lost to the cap are counted in cmr_overflow — loud,
    like every other static cap.  With compact_cap >= B this is a pure
    (stable) permutation of the batch: bit-identical results per read.

    SUPERSEDED in the production sharded paths by _global_shard_tail: a
    PER-SHARD budget mis-sizes whenever reads are position-correlated (a
    sorted batch owns one shard and needs B rows there — round-5 config-4
    silently unmapped half of every batch this way).  Kept for the
    compact_cap parameter of map_step_*_from_cands (unit-test surface).
    """
    B, L = reads.shape
    C = corr_start.shape[1]
    paired = pair_args is not None
    keep = n_cands > 0
    if paired:
        kp = keep.reshape(-1, 2)
        keep_g = kp[:, 0] | kp[:, 1]
        cap_g = compact_cap // 2
    else:
        keep_g = keep
        cap_g = compact_cap
    # stable argsort puts kept groups first IN READ ORDER, so the compacted
    # batch is a subsequence of the original — per-read tail results are
    # row-independent, hence identical to the uncompacted tail's
    order = jnp.argsort(jnp.where(keep_g, 0, 1).astype(jnp.int32))
    n_keep = jnp.sum(keep_g.astype(jnp.int32))
    sel_g = order[:cap_g]
    valid_g = jnp.arange(cap_g, dtype=jnp.int32) < jnp.minimum(n_keep, cap_g)
    n_lost = jnp.maximum(0, n_keep - cap_g)
    if paired:
        rows = jnp.stack([sel_g * 2, sel_g * 2 + 1], axis=1).reshape(-1)
        row_valid = jnp.repeat(valid_g, 2)
    else:
        rows, row_valid = sel_g, valid_g
    rows_safe = jnp.where(row_valid, rows, 0)
    Bc = rows.shape[0]

    # row gathers: reads/rc via the one-hot matmul (take_rows_mxu); the
    # small [B, C] candidate grids + [B] scalars as flat element gathers
    reads_c = take_rows_mxu(reads, rows_safe)
    rc_c = take_rows_mxu(rc, rows_safe)
    lengths_c = jnp.where(row_valid, lengths[rows_safe], 0)
    flat_bc = (rows_safe[:, None] * C
               + jax.lax.broadcasted_iota(jnp.int32, (Bc, C), 1)).reshape(-1)
    flat = lambda x: x.reshape(-1)[flat_bc].reshape(Bc, C)
    corr_c = flat(corr_start)
    strand_c = flat(strand)
    valid_c = (flat(cand_valid.astype(jnp.int32)) == 1) & row_valid[:, None]
    n_cands_c = jnp.where(row_valid, n_cands[rows_safe], 0)
    ovf = (overflow[0], overflow[1] + n_lost * (2 if paired else 1))

    if paired:
        res_c = _paired_tail(
            genome, reads_c, rc_c, lengths_c, matrices, gopen_q, gopen_r,
            gext, min_identity, min_residues, *pair_args,
            corr_c, strand_c, valid_c, n_cands_c, ovf,
            band=band, slot_cap=slot_cap, diag_bin_log2=diag_bin_log2,
            end_to_end=end_to_end,
            simple_matrix=simple_matrix,
        )
    else:
        res_c = _single_tail(
            genome, reads_c, rc_c, lengths_c, matrices, gopen_q, gopen_r,
            gext, min_identity, min_residues,
            corr_c, strand_c, valid_c, n_cands_c, ovf,
            band=band, slot_cap=slot_cap,
            end_to_end=end_to_end, simple_matrix=simple_matrix,
        )

    # scatter back to [B]; dropped rows keep zeroed defaults (score 0 =>
    # never owned by the merge)
    scat_idx = jnp.where(row_valid, rows, B)

    def scat(x):
        buf = jnp.zeros((B + 1,) + x.shape[1:], x.dtype)
        return buf.at[scat_idx].set(x)[:B]

    fields = {}
    for name in MapResult._fields:
        v = getattr(res_c, name)
        if name in ("fanout_overflow", "cmr_overflow"):
            fields[name] = v
        else:
            fields[name] = scat(v)
    return MapResult(**fields)


def _global_shard_tail(
    genome_s, reads, rc, lengths, matrices, gopen_q, gopen_r, gext,
    min_identity, min_residues, cands: CandState, best_g, pair_args=None,
    *, sensitivity, min_kmer_hits, band, slot_cap, diag_bin_log2,
    end_to_end, simple_matrix, compact_cap,
):
    """Post-CS tail over a CROSS-SHARD row budget (the skew-robust variant).

    _compacted_shard_tail gives each shard its own `2B/S` row budget, which
    assumes reads scatter ~uniformly over shards.  Position-SORTED input —
    the norm for BAM re-mapping, and for any per-chromosome read file —
    breaks that: a whole batch's reads own ONE shard, its tail needs B rows,
    and everything past the per-shard cap was dropped (counted, but still
    half-unmapped output; caught by the round-5 config-4 run, where every
    batch was single-chromosome).  Here the budget is GLOBAL: all (read,
    shard) groups with re-gated candidates anywhere compact into ONE row
    pool of `compact_cap` rows (default 2B — the same total tail work as
    S x 2B/S, but indifferent to how reads distribute over shards; a read
    has candidates in ~1 shard under the global threshold, so 2B covers a
    2x average).  The tail runs once over the pool with corridors gathered
    from the FLATTENED shard-stacked genome (per-shard corr_start is
    already clipped to its row, so windows never cross rows), and rows
    scatter back to the [S, B] layout the cross-shard merge expects.
    Groups lost to the cap are counted in cmr_overflow — loud, like every
    static cap.  Bit-identical to the uncompacted per-shard tails whenever
    nothing overflows (stable compaction; row-independent tail math).
    """
    S, B, C = cands.corr_start.shape
    Gs = genome_s.shape[1]
    flat_cands = CandState(
        cands.corr_start.reshape(S * B, C),
        cands.strand.reshape(S * B, C),
        cands.cs_score.reshape(S * B, C),
        jnp.tile(best_g, S),
        cands.fanout_overflow, cands.cmr_overflow,
        cands.extra_score.reshape(S * B),
    )
    corr_f, strand_f, valid_f, n_cands_f, cmr_total = _regate_candidates(
        flat_cands, jnp.tile(best_g, S), sensitivity, min_kmer_hits
    )
    keep = n_cands_f > 0                        # [S*B]
    paired = pair_args is not None
    if paired:
        kp = keep.reshape(S * B // 2, 2)
        keep_g = kp[:, 0] | kp[:, 1]
        cap_g = compact_cap // 2
        Bg = B // 2
    else:
        keep_g = keep
        cap_g = compact_cap
        Bg = B
    # stable order: kept groups first, shard-major then read order — the
    # same relative order the per-shard tails processed
    order = jnp.argsort(jnp.where(keep_g, 0, 1).astype(jnp.int32))
    n_keep = jnp.sum(keep_g.astype(jnp.int32))
    sel_g = order[:cap_g]
    valid_g = jnp.arange(cap_g, dtype=jnp.int32) < jnp.minimum(n_keep, cap_g)
    n_lost = jnp.maximum(0, n_keep - cap_g)
    sid_g = sel_g // Bg
    row_g = sel_g % Bg
    if paired:
        rows_b = jnp.stack([row_g * 2, row_g * 2 + 1], axis=1).reshape(-1)
        sid = jnp.repeat(sid_g, 2)
        row_valid = jnp.repeat(valid_g, 2)
    else:
        rows_b, sid, row_valid = row_g, sid_g, valid_g
    rows_safe = jnp.where(row_valid, rows_b, 0)
    sid_safe = jnp.where(row_valid, sid, 0)
    Bc = rows_b.shape[0]

    reads_c = take_rows_mxu(reads, rows_safe)
    rc_c = take_rows_mxu(rc, rows_safe)
    lengths_c = jnp.where(row_valid, lengths[rows_safe], 0)
    flat_bc = (
        (sid_safe * B + rows_safe)[:, None] * C
        + jax.lax.broadcasted_iota(jnp.int32, (Bc, C), 1)
    ).reshape(-1)
    flat = lambda x: x.reshape(-1)[flat_bc].reshape(Bc, C)
    strand_c = flat(strand_f)
    valid_c = (flat(valid_f.astype(jnp.int32)) == 1) & row_valid[:, None]
    n_cands_c = jnp.where(row_valid, n_cands_f[sid_safe * B + rows_safe], 0)
    # shard-local corridor starts -> flattened stacked-genome coordinates
    # (caller guarantees S * Gs < 2^31 so flat int32 coordinates are exact)
    corr_c = flat(corr_f) + sid_safe[:, None] * Gs
    genome_flat = genome_s.reshape(-1)
    ovf = (jnp.sum(cands.fanout_overflow),
           cmr_total + n_lost * (2 if paired else 1))

    if paired:
        res_c = _paired_tail(
            genome_flat, reads_c, rc_c, lengths_c, matrices, gopen_q,
            gopen_r, gext, min_identity, min_residues, *pair_args,
            corr_c, strand_c, valid_c, n_cands_c, ovf,
            band=band, slot_cap=slot_cap, diag_bin_log2=diag_bin_log2,
            end_to_end=end_to_end,
            simple_matrix=simple_matrix,
        )
    else:
        res_c = _single_tail(
            genome_flat, reads_c, rc_c, lengths_c, matrices, gopen_q,
            gopen_r, gext, min_identity, min_residues,
            corr_c, strand_c, valid_c, n_cands_c, ovf,
            band=band, slot_cap=slot_cap,
            end_to_end=end_to_end, simple_matrix=simple_matrix,
        )
    # positions came out in flattened coordinates; restore shard-local ones
    # (the merge adds each shard's base offset itself)
    res_c = res_c._replace(
        pos=jnp.where(row_valid, res_c.pos - sid_safe * Gs, 0)
    )

    # scatter rows back to the [S, B] per-shard layout; dropped rows keep
    # zeroed fields (score 0 => never owned by the merge)
    scat_idx = jnp.where(row_valid, sid * B + rows_b, S * B)

    def scat(x):
        buf = jnp.zeros((S * B + 1,) + x.shape[1:], x.dtype)
        return buf.at[scat_idx].set(x)[: S * B].reshape((S, B) + x.shape[1:])

    fields = {}
    for name in MapResult._fields:
        v = getattr(res_c, name)
        if name in ("fanout_overflow", "cmr_overflow"):
            # merge sums over the shard axis: totals ride shard 0's slot
            fields[name] = jnp.zeros((S,), v.dtype).at[0].set(v)
        else:
            fields[name] = scat(v)
    return MapResult(**fields)


@partial(jax.jit, static_argnames=_STATICS + ("compact_cap",))
def map_step_from_cands(
    genome, reads, lengths, matrices, gopen_q, gopen_r, gext,
    sensitivity, min_identity, min_residues, cand: CandState, best_g,
    pre_rc=None,
    *, k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, bs=False, bs_cutoff=0,
    end_to_end=False, packed_offsets=False,
    simple_matrix=False,
    canonical=False, cs_axis=None, word_cap=0, compact_cap=0,
) -> MapResult:
    """Phase 2 of the single-pass sequential shard loop: score + select +
    traceback from a shard's phase-1 candidate lists, with validity re-gated
    by the cross-shard best.  Byte-identical to map_step(best_floor=best_g)
    by the CandState invariant.  compact_cap > 0 runs the tail only on the
    reads with candidates in this shard (_compacted_shard_tail)."""
    B = reads.shape[0]
    rc = _shifted_rc(reads, lengths) if pre_rc is None else pre_rc
    corr_start, strand, cand_valid, n_cands, cmr_ovf = _regate_candidates(
        cand, best_g, sensitivity, min_kmer_hits
    )
    overflow = (cand.fanout_overflow, cmr_ovf)
    if compact_cap and compact_cap < B:
        return _compacted_shard_tail(
            genome, reads, rc, lengths, matrices, gopen_q, gopen_r, gext,
            min_identity, min_residues, corr_start, strand, cand_valid,
            n_cands, overflow,
            band=band, slot_cap=slot_cap or max(512, compact_cap // 2),
            diag_bin_log2=diag_bin_log2,
            end_to_end=end_to_end, simple_matrix=simple_matrix,
            compact_cap=compact_cap,
        )
    return _single_tail(
        genome, reads, rc, lengths, matrices, gopen_q, gopen_r, gext,
        min_identity, min_residues, corr_start, strand, cand_valid, n_cands,
        overflow, band=band, slot_cap=slot_cap or max(512, B // 2),
        end_to_end=end_to_end, simple_matrix=simple_matrix,
    )


@partial(jax.jit, static_argnames=_STATICS + ("compact_cap",))
def map_step_paired_from_cands(
    genome, reads, lengths, matrices, gopen_q, gopen_r, gext,
    sensitivity, min_identity, min_residues,
    min_insert, max_insert, pair_cutoff, cand: CandState, best_g,
    pre_rc=None,
    *, k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, bs=False, bs_cutoff=0,
    end_to_end=False, packed_offsets=False,
    simple_matrix=False,
    canonical=False, cs_axis=None, word_cap=0, compact_cap=0,
) -> MapResult:
    """Paired phase 2 of the single-pass sequential shard loop."""
    B = reads.shape[0]
    rc = _shifted_rc(reads, lengths) if pre_rc is None else pre_rc
    corr_start, strand, cand_valid, n_cands, cmr_ovf = _regate_candidates(
        cand, best_g, sensitivity, min_kmer_hits
    )
    overflow = (cand.fanout_overflow, cmr_ovf)
    if compact_cap and compact_cap < B:
        return _compacted_shard_tail(
            genome, reads, rc, lengths, matrices, gopen_q, gopen_r, gext,
            min_identity, min_residues, corr_start, strand, cand_valid,
            n_cands, overflow, (min_insert, max_insert, pair_cutoff),
            band=band, slot_cap=slot_cap or max(512, compact_cap // 2),
            diag_bin_log2=diag_bin_log2,
            end_to_end=end_to_end, simple_matrix=simple_matrix,
            compact_cap=compact_cap,
        )
    return _paired_tail(
        genome, reads, rc, lengths, matrices, gopen_q, gopen_r, gext,
        min_identity, min_residues, min_insert, max_insert, pair_cutoff,
        corr_start, strand, cand_valid, n_cands, overflow,
        band=band, slot_cap=slot_cap or max(512, B // 2),
        diag_bin_log2=diag_bin_log2,
        end_to_end=end_to_end,
        simple_matrix=simple_matrix,
    )


@partial(jax.jit,
         static_argnames=_STATICS + ("paired", "read_len", "compact_cap"))
def map_step_sharded_scan(
    genome_s, off_s, pos_s, base, core_lo, core_hi,
    reads, lengths, matrices, gopen_q, gopen_r, gext,
    sensitivity, max_freq, min_identity, min_residues,
    min_insert=None, max_insert=None, pair_cutoff=None,
    *, paired=False, read_len=0,
    k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, bs=False, bs_cutoff=0,
    end_to_end=False, packed_offsets=False,
    simple_matrix=False,
    canonical=False, cs_axis=None, word_cap=0, compact_cap=0,
) -> MapResult:
    """The ENTIRE sequential index-shard loop as ONE program: lax.scan over
    the stacked shard arrays for phase 1 (per-shard candidate lists), a
    cross-shard max for the global adaptive-threshold floor, a second scan
    for phase 2 (score/traceback per shard), and the deterministic merge —
    all inside a single jit.

    One dispatch per batch instead of the host loop's 2S.  Byte-identical
    to the host loop by construction (same phase functions, same merge)."""
    statics = dict(
        k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, band=band, min_kmer_hits=min_kmer_hits,
        slot_cap=slot_cap, read_stride=read_stride, bs=bs,
        bs_cutoff=bs_cutoff, end_to_end=end_to_end,
        packed_offsets=packed_offsets, simple_matrix=simple_matrix,
        canonical=canonical, cs_axis=cs_axis, word_cap=word_cap,
    )
    # reads are loop-invariant across shards: extract rc + k-mer windows ONCE
    # and close over them in both scan bodies (XLA is not guaranteed to hoist)
    pre = _pre_extract(reads, lengths, k=k, read_stride=read_stride, bs=bs,
                       bs_cutoff=bs_cutoff, canonical=canonical)

    def cs_body(carry, xs):
        g, o, p = xs
        c = cs_cands_step(g, o, p, reads, lengths, sensitivity, max_freq,
                          pre, **statics)
        return carry, c

    _, cands = jax.lax.scan(cs_body, 0, (genome_s, off_s, pos_s))
    best_g = jnp.max(cands.best, axis=0)

    S, B = genome_s.shape[0], reads.shape[0]
    # cross-shard compacted tail: one GLOBAL row budget instead of 2B/S per
    # shard (per-shard budgets silently starve position-sorted input whose
    # batches own a single shard — _global_shard_tail docstring).  The
    # flattened-genome corridor coordinates need S*Gs < 2^31; past that the
    # uncompacted per-shard tails run instead.
    use_global = (
        compact_cap and compact_cap < S * B
        and S * genome_s.shape[1] < 2**31
    )
    if use_global:
        stk = _global_shard_tail(
            genome_s, reads, pre[0], lengths, matrices, gopen_q, gopen_r,
            gext, min_identity, min_residues, cands, best_g,
            (min_insert, max_insert, pair_cutoff) if paired else None,
            sensitivity=sensitivity, min_kmer_hits=min_kmer_hits,
            band=band, slot_cap=slot_cap or max(512, compact_cap // 2),
            diag_bin_log2=diag_bin_log2,
            end_to_end=end_to_end, simple_matrix=simple_matrix,
            compact_cap=compact_cap,
        )
    else:
        def tail_body(carry, xs):
            g, c = xs
            if paired:
                r = map_step_paired_from_cands(
                    g, reads, lengths, matrices, gopen_q, gopen_r, gext,
                    sensitivity, min_identity, min_residues,
                    min_insert, max_insert, pair_cutoff, c, best_g, pre[0],
                    **statics,
                )
            else:
                r = map_step_from_cands(
                    g, reads, lengths, matrices, gopen_q, gopen_r, gext,
                    sensitivity, min_identity, min_residues, c, best_g,
                    pre[0], **statics,
                )
            return carry, r

        _, stk = jax.lax.scan(tail_body, 0, (genome_s, cands))
    # runtime import: parallel.index_shard imports this module (MapResult)
    from nextgenmap_tpu.parallel.index_shard import merge_sharded_results

    return merge_sharded_results(
        stk, base, core_lo, core_hi, paired=paired, read_len=read_len,
    )


@partial(jax.jit,
         static_argnames=_STATICS + ("paired", "read_len", "compact_cap"))
def map_step_sharded_megascan(
    genome_s, off_s, pos_s, base, core_lo, core_hi,
    reads_k, lengths_k, matrices, gopen_q, gopen_r, gext,
    sensitivity, max_freq, min_identity, min_residues,
    min_insert=None, max_insert=None, pair_cutoff=None,
    *, paired=False, read_len=0,
    k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, bs=False, bs_cutoff=0,
    end_to_end=False, packed_offsets=False,
    simple_matrix=False,
    canonical=False, cs_axis=None, word_cap=0, compact_cap=0,
) -> MapResult:
    """MEGABATCH x SHARDS: K read batches through the fused sequential shard
    loop in ONE program (outer lax.scan over [K, B, L], body =
    map_step_sharded_scan).  Fields come back stacked [K, ...].

    One dispatch and one result fetch per K batches.  Bit-identical per
    batch to K separate map_step_sharded_scan calls: the scan body IS that
    function."""
    statics = dict(
        k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, band=band, min_kmer_hits=min_kmer_hits,
        slot_cap=slot_cap, read_stride=read_stride, bs=bs,
        bs_cutoff=bs_cutoff, end_to_end=end_to_end,
        packed_offsets=packed_offsets, simple_matrix=simple_matrix,
        canonical=canonical, cs_axis=cs_axis, word_cap=word_cap,
    )
    pair_args = (min_insert, max_insert, pair_cutoff) if paired else ()

    def body(carry, xs):
        reads, lengths = xs
        r = map_step_sharded_scan(
            genome_s, off_s, pos_s, base, core_lo, core_hi,
            reads, lengths, matrices, gopen_q, gopen_r, gext,
            sensitivity, max_freq, min_identity, min_residues,
            *pair_args, paired=paired, read_len=read_len,
            compact_cap=compact_cap, **statics,
        )
        return carry, r

    _, rs = jax.lax.scan(body, 0, (reads_k, lengths_k))
    return rs


@partial(jax.jit, static_argnames=_STATICS + ("paired",))
def map_step_scan(
    genome, offsets, positions, reads_k, lengths_k, matrices,
    gopen_q, gopen_r, gext, sensitivity, max_freq, min_identity, min_residues,
    min_insert=None, max_insert=None, pair_cutoff=None,
    *, paired=False,
    k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, bs=False, bs_cutoff=0,
    end_to_end=False, packed_offsets=False,
    simple_matrix=False,
    canonical=False, cs_axis=None, word_cap=0,
) -> MapResult:
    """MEGABATCH step: K read batches in ONE program (lax.scan over [K,B,L]).

    Folding K batches into one scan pays the dispatch and the result fetch
    once per K batches.  Results are bit-identical to K separate map_step
    calls: the scan body IS map_step.
    """
    statics = dict(
        k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, band=band, min_kmer_hits=min_kmer_hits,
        slot_cap=slot_cap, read_stride=read_stride, bs=bs,
        bs_cutoff=bs_cutoff, end_to_end=end_to_end,
        packed_offsets=packed_offsets, simple_matrix=simple_matrix,
        canonical=canonical, cs_axis=cs_axis, word_cap=word_cap,
    )

    def body(carry, xs):
        reads, lengths = xs
        if paired:
            r = map_step_paired(
                genome, offsets, positions, reads, lengths, matrices,
                gopen_q, gopen_r, gext, sensitivity, max_freq,
                min_identity, min_residues,
                min_insert, max_insert, pair_cutoff, **statics,
            )
        else:
            r = map_step(
                genome, offsets, positions, reads, lengths, matrices,
                gopen_q, gopen_r, gext, sensitivity, max_freq,
                min_identity, min_residues, **statics,
            )
        return carry, r

    _, rs = jax.lax.scan(body, 0, (reads_k, lengths_k))
    return rs


@partial(jax.jit, static_argnames=_STATICS + ("topn",))
def map_step_topn_from_cands(
    genome, reads, lengths, matrices, gopen_q, gopen_r, gext,
    sensitivity, min_identity, min_residues, cand: CandState, best_g,
    *, k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, bs=False, bs_cutoff=0,
    end_to_end=False, packed_offsets=False,
    simple_matrix=False, topn=2,
    canonical=False, cs_axis=None, word_cap=0,
) -> tuple:
    """Topn phase 2 of the single-pass sequential shard loop (ref -n with
    --index-shards): each shard traces its local top ranks; the cross-shard
    rank merge (parallel/index_shard.py::merge_sharded_topn) interleaves the
    per-shard lists, which is exact because any global top-R entry is within
    its own shard's top R."""
    B = reads.shape[0]
    slot_cap = slot_cap or 2 * B
    rc = _shifted_rc(reads, lengths)
    corr_start, strand, cand_valid, n_cands, cmr_ovf = _regate_candidates(
        cand, best_g, sensitivity, min_kmer_hits
    )
    overflow = (cand.fanout_overflow, cmr_ovf)
    return _topn_tail(
        genome, reads, rc, lengths, matrices, gopen_q, gopen_r, gext,
        min_identity, min_residues, corr_start, strand, cand_valid, n_cands,
        overflow, band=band, slot_cap=slot_cap,
        end_to_end=end_to_end, topn=topn, simple_matrix=simple_matrix,
    )


@partial(jax.jit, static_argnames=_STATICS + ("topn",))
def map_step_topn(
    genome, offsets, positions, reads, lengths, matrices,
    gopen_q, gopen_r, gext, sensitivity, max_freq, min_identity, min_residues,
    *, k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, bs=False, bs_cutoff=0,
    end_to_end=False, packed_offsets=False,
    simple_matrix=False, topn=2,
    canonical=False, cs_axis=None, word_cap=0,
) -> tuple:
    """Single-end mapping with up to `topn` alignments per read (ref -n).

    Returns a tuple of `topn` MapResults ordered score DESC (DESIGN.md rule
    11 tie-breaking); entry j is valid for a read where its score > 0.  The
    host emitter applies --strata (keep only the top-score stratum) and
    near-duplicate suppression, and marks entries 1.. as SAM secondary.
    Ranking needs every candidate's score, so scoring is eager here.
    """
    B = reads.shape[0]
    slot_cap = slot_cap or 2 * B
    corr_start, strand, cand_valid, _, n_cands, rc, _, overflow, _ = _candidates(
        genome, offsets, positions, reads, lengths, sensitivity, max_freq,
        k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, band=band, min_kmer_hits=min_kmer_hits,
        read_stride=read_stride, bs=bs, bs_cutoff=bs_cutoff, cs_axis=cs_axis,
        packed_offsets=packed_offsets, canonical=canonical,
        word_cap=word_cap,
    )
    return _topn_tail(
        genome, reads, rc, lengths, matrices, gopen_q, gopen_r, gext,
        min_identity, min_residues, corr_start, strand, cand_valid, n_cands,
        overflow, band=band, slot_cap=slot_cap,
        end_to_end=end_to_end, topn=topn, simple_matrix=simple_matrix,
    )


def _topn_tail(
    genome, reads, rc, lengths, matrices, gopen_q, gopen_r, gext,
    min_identity, min_residues, corr_start, strand, cand_valid, n_cands,
    overflow, *, band, slot_cap, end_to_end, topn,
    simple_matrix=False,
):
    """Everything after candidate search for the topn step: eager scoring,
    rank selection, ONE compacted traceback for all ranks."""
    B = reads.shape[0]
    sw, slot_ovf = _score_candidates(
        genome, reads, rc, lengths, corr_start, strand, cand_valid,
        jnp.ones(B, dtype=bool), matrices, gopen_q, gopen_r, gext,
        band=band, slot_cap=slot_cap,
        end_to_end=end_to_end, simple_matrix=simple_matrix,
    )
    overflow = (overflow[0], overflow[1] + slot_ovf)
    proper = jnp.zeros(B, dtype=bool)
    L = reads.shape[1]
    T = L + band
    G = genome.shape[0]
    R = topn
    _, top_idx = jax.lax.top_k(sw, R)      # stable: rule 11 order
    # per-rank validity: entries past a read's candidate list land on
    # zero-score grid cells — gate them so they cannot alias candidate 0.
    # Validity is a PREFIX along ranks: scores are sorted DESC, and rank 0
    # of a no-score read falls on candidate 0 (the valid-prefix ordering)
    tv = jnp.take_along_axis(cand_valid, top_idx, axis=1)        # [B, R]
    ts = jnp.take_along_axis(sw, top_idx, axis=1)
    jr = jax.lax.broadcasted_iota(jnp.int32, (B, R), 1)
    rvalid = tv & ((jr == 0) | (ts > 0))                         # [B, R]
    t_start = jnp.take_along_axis(corr_start, top_idx, axis=1)
    t_strand = jnp.take_along_axis(strand, top_idx, axis=1)

    # ONE traceback DP for all ranks (VERDICT r2 directive 7): compact the
    # valid (read, rank) pairs into slots — most reads have a single
    # candidate, so the slot count ~B real rows instead of R full [B] DP
    # passes over mostly-invalid winners
    S2 = slot_cap
    n_r = jnp.sum(rvalid.astype(jnp.int32), axis=1)              # [B]
    base = jnp.cumsum(n_r) - n_r
    total = base[-1] + n_r[-1]
    slot2_ovf = (total > S2).astype(jnp.int32)
    sar = jax.lax.broadcasted_iota(jnp.int32, (S2, 1), 0)[:, 0]
    ge = sar[:, None] >= base[None, :]
    b_of = jnp.sum(ge.astype(jnp.int32), axis=1) - 1             # [S2]
    slot_valid = sar < jnp.minimum(total, S2)
    onehot_b = jax.lax.broadcasted_iota(jnp.int32, (S2, B), 1) == b_of[:, None]
    base_at = jnp.sum(jnp.where(onehot_b, base[None, :], 0), axis=1)
    j_of = sar - base_at                       # = the rank (prefix validity)
    b_safe = jnp.where(slot_valid, b_of, 0)
    flat_bj = jnp.where(slot_valid, b_of * R + j_of, 0)

    start_s = t_start.reshape(-1)[flat_bj]
    strand_s = t_strand.reshape(-1)[flat_bj]
    len_s = lengths[b_safe]
    starts = jnp.clip(jnp.where(slot_valid, start_s, 0), 0, max(0, G - T))
    corr_s = gather_windows(pad_table(genome, T, 4), starts, T)
    corr_s = jnp.where(slot_valid[:, None], corr_s, 4)
    q2 = jnp.concatenate([reads, rc], axis=0)
    q_s = take_rows_mxu(q2, strand_s * B + b_safe)
    ares = banded_sw_align(
        q_s, len_s, corr_s, matrices, gopen_q, gopen_r, gext, strand_s,
        band=band, mode="glocal" if end_to_end else "local",
        simple=simple_matrix,
    )
    overflow = (
        overflow[0],
        overflow[1] + slot2_ovf
        + jnp.sum(jnp.where(slot_valid, ares.trunc.astype(jnp.int32), 0)),
    )

    # scatter every align field back to the [B, R] rank grid
    scat_idx = jnp.where(slot_valid, flat_bj, B * R)

    def scat(x, dtype=None):
        flat = jnp.zeros((B * R + 1,) + x.shape[1:],
                         dtype or x.dtype).at[scat_idx].set(x)
        return flat[: B * R].reshape((B, R) + x.shape[1:])

    g_score = scat(jnp.where(slot_valid, ares.score, 0))
    g_qs = scat(ares.q_start)
    g_qe = scat(ares.q_end)
    g_rs = scat(ares.r_start)
    g_ops = scat(ares.ops)
    g_nops = scat(ares.n_ops)
    g_match = scat(ares.matches)
    g_mis = scat(ares.mismatches)
    g_ind = scat(ares.indels)
    g_trunc = scat(ares.trunc)

    # second-best at a DIFFERENT locus per rank (same rule as _finish)
    far = (
        jnp.abs(corr_start[:, None, :] - t_start[:, :, None]) > L
    )                                                            # [B, R, C]
    s2 = jnp.max(jnp.where(far, sw[:, None, :], 0), axis=2)      # [B, R]

    results = []
    for j in range(R):
        s1 = g_score[:, j]
        aln_cols = jnp.maximum(1, g_nops[:, j])
        identity = g_match[:, j].astype(jnp.float32) / aln_cols.astype(jnp.float32)
        residues = (g_qe[:, j] - g_qs[:, j] + 1).astype(jnp.float32)
        mapped = (
            (s1 > 0) & (lengths > 0)
            & (identity >= min_identity)
            & (residues >= min_residues * lengths.astype(jnp.float32))
            & ~g_trunc[:, j]
        )
        s1f = jnp.maximum(1, s1).astype(jnp.float32)
        mapq = jnp.clip(
            jnp.round(60.0 * (s1 - s2[:, j]).astype(jnp.float32) / s1f), 0, 60
        ).astype(jnp.int32)
        results.append(MapResult(
            mapped=mapped,
            strand=t_strand[:, j],
            pos=t_start[:, j] + g_rs[:, j],
            mapq=jnp.where(mapped, mapq, 0),
            score=s1,
            second=s2[:, j],
            q_start=g_qs[:, j],
            q_end=g_qe[:, j],
            ops=g_ops[:, j],
            n_ops=g_nops[:, j],
            matches=g_match[:, j],
            mismatches=g_mis[:, j],
            indels=g_ind[:, j],
            n_candidates=n_cands,
            proper=proper,
            fanout_overflow=overflow[0],
            cmr_overflow=overflow[1],
        ))
    return tuple(results)


@partial(jax.jit, static_argnames=_STATICS)
def map_step_paired(
    genome, offsets, positions, reads, lengths, matrices,
    gopen_q, gopen_r, gext, sensitivity, max_freq, min_identity, min_residues,
    min_insert, max_insert, pair_cutoff, best_floor=None,
    *, k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, bs=False, bs_cutoff=0,
    end_to_end=False, packed_offsets=False,
    simple_matrix=False,
    canonical=False, cs_axis=None, word_cap=0,
) -> MapResult:
    """Paired-end step: rows 2i/2i+1 are mates (DESIGN.md rule 13).

    Pair resolution is a CxC combined-score argmax per pair over an
    FR-orientation + insert-window validity mask, computed from candidate
    corridor positions (like the reference, pairing happens on scores before
    traceback).  Falls back to best singletons when no pair clears
    pair_cutoff * (best1 + best2) — the "broken pair" path.

    Lazy scoring: a pair where BOTH mates have exactly one candidate has
    nothing to compare — its only combination is (0, 0), whose propriety is
    pure geometry (orientation + insert window) and whose scores come from
    the traceback DP.
    """
    B = reads.shape[0]
    # lazy scoring rarely needs many slots (most reads have 1 candidate);
    # overflow is counted, so a repeat-dense genome is visible, not silent
    slot_cap = slot_cap or max(512, B // 2)
    corr_start, strand, cand_valid, _, n_cands, rc, _, overflow, _ = _candidates(
        genome, offsets, positions, reads, lengths, sensitivity, max_freq,
        best_floor,
        k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, band=band, min_kmer_hits=min_kmer_hits,
        read_stride=read_stride, bs=bs, bs_cutoff=bs_cutoff, cs_axis=cs_axis,
        packed_offsets=packed_offsets, canonical=canonical,
        word_cap=word_cap,
    )
    return _paired_tail(
        genome, reads, rc, lengths, matrices, gopen_q, gopen_r, gext,
        min_identity, min_residues, min_insert, max_insert, pair_cutoff,
        corr_start, strand, cand_valid, n_cands, overflow,
        band=band, slot_cap=slot_cap, diag_bin_log2=diag_bin_log2,
        end_to_end=end_to_end,
        simple_matrix=simple_matrix,
    )


@dataclass
class Mapper:
    """Host-side handle: owns device-resident genome + index and the jitted step.

    index=None (the default path) builds the CSR table ON DEVICE
    (index/device_build.py) — milliseconds instead of the host two-pass scan;
    pass a host KmerIndex to reuse a memoized artifact instead.
    """

    cfg: NgmConfig
    genome: Genome
    read_len: int
    index: KmerIndex | tuple | None = None

    def __post_init__(self):
        if self.cfg.index_shards > 1:
            self._init_sharded()
            return
        self._sharded = None
        self._genome_dev = jax.device_put(jnp.asarray(self.genome.codes))
        # canonical k-mer indexing (one lookup serves both strands) whenever
        # possible: not bisulfite (strand-asymmetric collapses) and the
        # (pos << 1) encoding fits int32
        self._canonical = (
            not self.cfg.bs_mapping
            and self.genome.codes.shape[0] < 2**30
        )
        if self.cfg.bs_mapping:
            # two collapsed CSR tables, concatenated: fwd pass looks up the
            # CT table, rc pass the GA table (offsets pre-shifted into the
            # shared positions array, whose int32 offsets must hold both)
            G = self.genome.codes.shape[0]
            n_pos = (2 * ((G - self.cfg.kmer) // self.cfg.kmer_skip + 1)
                     if self.index is None
                     else sum(i.positions.shape[0] for i in self.index))
            if n_pos >= 2**31:
                raise ValueError(
                    f"bisulfite CT + GA tables of {n_pos} positions too "
                    "large for single-shard int32; shard it (--index-shards)"
                )
            if self.index is None:
                from nextgenmap_tpu.index.device_build import build_index_device

                off1, pos1 = build_index_device(
                    self._genome_dev, k=self.cfg.kmer, skip=self.cfg.kmer_skip,
                    collapse="ct",
                )
                off2, pos2 = build_index_device(
                    self._genome_dev, k=self.cfg.kmer, skip=self.cfg.kmer_skip,
                    collapse="ga",
                )
            else:
                idx_ct, idx_ga = self.index
                o1, p1 = idx_ct.device_arrays()
                o2, p2 = idx_ga.device_arrays()
                off1, pos1 = jnp.asarray(o1), jnp.asarray(p1)
                off2, pos2 = jnp.asarray(o2), jnp.asarray(p2)
            self._off_dev = jnp.concatenate([off1, off2 + pos1.shape[0]])
            self._pos_dev = jnp.concatenate([pos1, pos2])
        elif self.index is None:
            from nextgenmap_tpu.index.device_build import build_index_device

            off, pos = build_index_device(
                self._genome_dev, k=self.cfg.kmer, skip=self.cfg.kmer_skip,
                canonical=self._canonical,
            )
            self._off_dev, self._pos_dev = off, pos
        else:
            self._canonical = getattr(self.index, "canonical", False)
            off, pos = self.index.device_arrays()
            self._off_dev = jax.device_put(jnp.asarray(off))
            self._pos_dev = jax.device_put(jnp.asarray(pos))
        # pack (o0, row length) into one uint32 table when the index is
        # small enough — halves the CS offset gathers.  Chosen on another
        # chip; not measured on the H100.  NGM_PACK_OFFSETS=0 disables for
        # A/B.
        import os as _os

        self._packed_offsets = False
        if _os.environ.get("NGM_PACK_OFFSETS", "1") != "0":
            from nextgenmap_tpu.ops.candidate import pack_offsets

            packed = pack_offsets(
                self._off_dev, self.cfg.max_kmer_freq, self.cfg.max_kmer_fanout
            )
            self._packed_offsets = packed is not None
            if packed is not None:
                self._off_dev = packed
        mats_np = np.stack([score_matrix(self.cfg, 0), score_matrix(self.cfg, 1)])
        self._matrices = jnp.asarray(mats_np)
        from nextgenmap_tpu.ops.scoring import matrices_are_simple

        self._simple = matrices_are_simple(mats_np)
        self.band = self.cfg.corridor_for(self.read_len)
        n_pos = self._pos_dev.shape[0] // (2 if self.cfg.bs_mapping else 1)
        self.hit_cap = self.cfg.resolved_read_hits(n_pos, self.read_len)
        # word-gather CS path: positions padded to 8-wide rows so the
        # [B, H] element gather becomes a [B, HW] row gather
        # (ops/candidate.py word_cap docs).  OPT-IN via NGM_WORD_GATHER=1:
        # it was at par with the element path on another chip, where the
        # [P/8, 8] view also cost a padded tiled layout; tuned on another
        # chip, not measured on the H100.
        from nextgenmap_tpu.ops.candidate import pad_positions8

        self._pos_dev = pad_positions8(self._pos_dev)
        self.word_cap = 0
        if not self.cfg.bs_mapping and _os.environ.get(
                "NGM_WORD_GATHER", "0") == "1":
            self.word_cap = self.cfg.resolved_word_cap(
                n_pos, self.read_len, self.hit_cap, canonical=self._canonical
            )

        # data parallelism over devices (the dp analog of reference -t):
        # shard_map over a 1-D mesh; genome/index/matrices replicated
        self.n_devices = self.cfg.devices or len(jax.local_devices())
        if self.n_devices > 1:
            from jax.sharding import NamedSharding, PartitionSpec

            from nextgenmap_tpu.parallel.dp import make_dp_map_step
            from nextgenmap_tpu.parallel.mesh import make_mesh

            self._mesh = make_mesh(self.n_devices)
            # place the tables on every mesh device once; left on the
            # default device they would be copied out again at every step
            rep = NamedSharding(self._mesh, PartitionSpec())
            self._genome_dev, self._off_dev, self._pos_dev, self._matrices = (
                jax.device_put(x, rep) for x in (
                    self._genome_dev, self._off_dev, self._pos_dev,
                    self._matrices,
                )
            )
            self._dp_single = make_dp_map_step(
                self._mesh, paired=False, **self._statics()
            )
            self._dp_paired = make_dp_map_step(
                self._mesh, paired=True, **self._statics()
            )

    def _init_sharded(self):
        """Position-range index sharding (BASELINE config 4, SURVEY.md §2.2).

        Two execution modes behind the same `map_batch` API:
        - n_devices a multiple of n_shards: ("dp", "ish") mesh, all shards in
          parallel, all_gather merge (parallel/index_shard.py).
        - one device (or fewer than n_shards): SEQUENTIAL shard loop on that
          device — phase 1 computes every shard's best CS bucket count, the
          host maxes them into the global adaptive-threshold floor, phase 2
          runs the full step per shard, and merge_sharded_results combines
          the stacked per-shard results with the same merge keys as the mesh
          path.  This is what makes a >2^31-base genome (GRCh38) mappable on
          a SINGLE chip: each shard rebases positions into its own int32
          range.
        """
        from nextgenmap_tpu.parallel.index_shard import ShardedIndex

        cfg = self.cfg
        S = cfg.index_shards
        if isinstance(self.index, ShardedIndex):
            sidx = self.index          # prebuilt/memoized by the runner
            if sidx.n_shards != S:
                raise ValueError(
                    f"sharded index has {sidx.n_shards} shards, want {S}"
                )
            if sidx.dual != cfg.bs_mapping:
                raise ValueError(
                    "sharded index dual-table layout does not match "
                    "--bs-mapping"
                )
        elif cfg.bs_mapping:
            # bisulfite: (CT, GA) collapsed host indexes, sharded by the
            # same position ranges into per-shard concatenated dual tables
            if not (isinstance(self.index, tuple) and len(self.index) == 2):
                raise ValueError(
                    "bisulfite index sharding requires a (CT, GA) "
                    "host-built KmerIndex pair"
                )
            halo = ShardedIndex.halo_for(cfg, self.read_len, paired=True)
            sidx = ShardedIndex.build_dual(
                *self.index, self.genome.codes, S, halo
            )
        elif isinstance(self.index, KmerIndex):
            # canonical indexes slice fine: (pos<<1)|flip entries are
            # monotone in pos, and the per-shard rebase restores int32
            halo = ShardedIndex.halo_for(cfg, self.read_len, paired=True)
            sidx = ShardedIndex.build(self.index, self.genome.codes, S, halo)
        else:
            raise ValueError(
                "index sharding requires a host-built KmerIndex"
            )
        import dataclasses as _dc
        import os as _os

        from nextgenmap_tpu.ops.candidate import WORD_W

        wpad = (-sidx.positions.shape[1]) % WORD_W
        if wpad:
            sidx = _dc.replace(sidx, positions=np.pad(
                sidx.positions, ((0, 0), (0, wpad))
            ))
        self._sharded = sidx
        self._canonical = bool(getattr(sidx, "canonical", False))
        self._packed_offsets = False
        self._matrices_np = np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])
        self._matrices = jnp.asarray(self._matrices_np)
        from nextgenmap_tpu.ops.scoring import matrices_are_simple

        self._simple = matrices_are_simple(self._matrices_np)
        self.band = cfg.corridor_for(self.read_len)
        # per-shard hit cap sized to per-shard index density — the point of
        # sharding: S shards each see ~1/S of the hits (dual: the padded
        # width spans both collapsed tables).  Pmax is a GLOBAL maximum even
        # for a cross-host subset, so every process resolves the same cap.
        self.hit_cap = cfg.resolved_read_hits(
            sidx.positions.shape[1] // (2 if sidx.dual else 1), self.read_len
        )
        self.word_cap = 0
        if not cfg.bs_mapping and _os.environ.get(
                "NGM_WORD_GATHER", "0") == "1":  # opt-in; see Mapper above
            self.word_cap = cfg.resolved_word_cap(
                sidx.positions.shape[1] // (2 if sidx.dual else 1),
                self.read_len, self.hit_cap, canonical=self._canonical,
            )
        self.n_devices = cfg.devices or len(jax.local_devices())
        self._cross_host = False
        if cfg.shard_hosts:
            # cross-host index sharding (north-star config 4): a GLOBAL
            # ("dp", "ish") mesh where each host's devices cover only its
            # own shard columns; this host's ShardedIndex subset rows are
            # placed per-device via make_array_from_single_device_arrays
            from nextgenmap_tpu.parallel.index_shard import (
                global_ish_mesh, local_shard_ids, make_global_ish_arrays,
                make_index_sharded_map_step,
            )

            mesh = global_ish_mesh(S)
            own = local_shard_ids(mesh)
            have = (list(range(S)) if sidx.shard_ids is None
                    else [int(x) for x in sidx.shard_ids])
            if not set(own) <= set(have):
                raise ValueError(
                    f"this host's devices need shards {own} but the local "
                    f"index subset holds {have}"
                )
            self._cross_host = True
            self._base = jnp.asarray(sidx.base)
            self._clo = jnp.asarray(sidx.core_lo)
            self._chi = jnp.asarray(sidx.core_hi)
            self._ish_args = make_global_ish_arrays(mesh, sidx)
            self._ish_single = make_index_sharded_map_step(
                mesh, paired=False, read_len=self.read_len, **self._statics()
            )
            self._ish_paired = make_index_sharded_map_step(
                mesh, paired=True, read_len=self.read_len, **self._statics()
            )
            self._shard_args = None
            return
        self._base = jnp.asarray(sidx.base)
        self._clo = jnp.asarray(sidx.core_lo)
        self._chi = jnp.asarray(sidx.core_hi)
        if self.n_devices > 1 and self.n_devices % S == 0:
            from jax.sharding import NamedSharding, PartitionSpec

            from nextgenmap_tpu.parallel.index_shard import (
                make_index_sharded_map_step,
            )
            from nextgenmap_tpu.parallel.mesh import make_mesh

            mesh = make_mesh(self.n_devices, index_shards=S)
            # each shard's row goes straight from the host to the devices of
            # its ish column (never all of them through the default device)
            ish = NamedSharding(mesh, PartitionSpec("ish"))
            self._ish_args = tuple(
                jax.device_put(x, ish) for x in (
                    sidx.genome, sidx.offsets, sidx.positions,
                    sidx.base, sidx.core_lo, sidx.core_hi,
                )
            )
            self._ish_single = make_index_sharded_map_step(
                mesh, paired=False, read_len=self.read_len, **self._statics()
            )
            self._ish_paired = make_index_sharded_map_step(
                mesh, paired=True, read_len=self.read_len, **self._statics()
            )
            self._shard_args = None
        elif self.n_devices == 1:
            # Device placement is LAZY and exclusive per mode: the fused scan
            # uses ONE stacked array; the host loop / topn paths use
            # per-shard buffers.  Materializing both (the old "slice the
            # stack" _shard_list) doubled device memory for the tables.
            self._shard_stack_np = (sidx.genome, sidx.offsets, sidx.positions)
            self._shard_stack = None
            self._shard_args = "seq"   # sentinel: sequential one-device mode
            self._shard_list_cache = None
        else:
            raise ValueError(
                f"index_shards={S} needs 1 device (sequential) or a device "
                f"count divisible by {S}, got {self.n_devices}"
            )

    def _map_sharded(self, codes, lengths, paired: bool, pair_args=()) -> MapResult:
        from nextgenmap_tpu.parallel.index_shard import merge_sharded_results

        cfg = self.cfg
        if self._cross_host:
            # multi-process mesh: inputs must be either the pre-placed global
            # index arrays or UNCOMMITTED host values (identical on every
            # process, auto-replicated per in_specs); a jnp.asarray here
            # would commit to local device 0 and break cross-process placement
            reads = np.ascontiguousarray(codes)
            lens = np.asarray(lengths, np.int32)
            scalars = (
                self._matrices_np,
                np.int32(cfg.gap_read_penalty), np.int32(cfg.gap_ref_penalty),
                np.int32(cfg.gap_extend_penalty),
                np.float32(cfg.sensitivity), np.int32(cfg.max_kmer_freq),
                np.float32(cfg.min_identity), np.float32(cfg.min_residues),
            )
            pair_args = tuple(np.asarray(x) for x in pair_args)
            fn = self._ish_paired if paired else self._ish_single
            return fn(*self._ish_args, reads, lens, *scalars, *pair_args)
        reads = jnp.asarray(codes)
        lens = jnp.asarray(lengths, jnp.int32)
        scalars = (
            self._matrices,
            jnp.int32(cfg.gap_read_penalty), jnp.int32(cfg.gap_ref_penalty),
            jnp.int32(cfg.gap_extend_penalty),
            jnp.float32(cfg.sensitivity), jnp.int32(cfg.max_kmer_freq),
            jnp.float32(cfg.min_identity), jnp.float32(cfg.min_residues),
        )
        if self._shard_args is None:  # mesh path
            fn = self._ish_paired if paired else self._ish_single
            return fn(*self._ish_args, reads, lens, *scalars, *pair_args)
        # SEQUENTIAL path (one device): by default the WHOLE loop — phase-1
        # CS per shard, cross-shard best, phase-2 tails, merge — runs as ONE
        # scan program (map_step_sharded_scan), one dispatch per batch.
        # NGM_SHARD_LOOP=host runs the bit-identical host-driven loop, which
        # compiles S small programs instead of one large one.
        import os as _os

        mode = _os.environ.get("NGM_SHARD_LOOP")
        if mode is None and cfg.bs_mapping:
            # bisulfite's dual collapsed tables double the fused program;
            # the host loop is its default (chosen on another chip, not
            # measured on the H100).  NGM_SHARD_LOOP=scan forces the scan.
            mode = "host"
        if mode != "host":
            return map_step_sharded_scan(
                *self._stack(), self._base, self._clo, self._chi,
                reads, lens, *scalars, *pair_args,
                paired=paired, read_len=self.read_len,
                compact_cap=self._shard_tail_cap(reads.shape[0], paired),
                **self._statics(),
            )
        sens = jnp.float32(cfg.sensitivity)
        mf = jnp.int32(cfg.max_kmer_freq)
        statics = self._statics()
        cands = [
            cs_cands_step(g, o, p, reads, lens, sens, mf, **statics)
            for (g, o, p) in self._shard_list()
        ]
        best = jnp.max(jnp.stack([c.best for c in cands]), axis=0)
        step = map_step_paired_from_cands if paired else map_step_from_cands
        # matrices first, then gap penalties; sensitivity rides scalars[4]
        # NOTE: the host loop runs FULL per-shard tails (no compact_cap) —
        # the per-shard 2B/S budget mis-sizes under read->shard skew
        # (_global_shard_tail docstring), and the skew-robust global tail
        # needs all shards' candidates in one program, which is what this
        # loop exists to avoid
        results = [
            step(g, reads, lens, scalars[0], scalars[1], scalars[2],
                 scalars[3], scalars[4], scalars[6], scalars[7],
                 *pair_args, c, best, **statics)
            for (g, _, _), c in zip(self._shard_list(), cands)
        ]
        stk = MapResult(*[
            jnp.stack([getattr(r, f) for r in results])
            for f in MapResult._fields
        ])
        return merge_sharded_results(
            stk, self._base, self._clo, self._chi,
            paired=paired, read_len=self.read_len,
        )

    def _stack(self):
        """Device-resident stacked shard arrays (fused-scan path), lazy."""
        if self._shard_stack is None:
            g, o, p = self._shard_stack_np
            self._shard_stack = (
                jax.device_put(jnp.asarray(g)),
                jax.device_put(jnp.asarray(o)),
                jax.device_put(jnp.asarray(p)),
            )
        return self._shard_stack

    def _shard_list(self):
        """Per-shard (genome, offsets, positions) device rows for the topn
        and host-loop paths — device_put from the HOST arrays, never sliced
        out of the device stack (that would hold both and double HBM)."""
        if self._shard_list_cache is None:
            import time as _t

            from nextgenmap_tpu.utils.logging import get_logger

            log = get_logger("ngm-tpu.map")
            g, o, p = self._shard_stack_np
            rows = []
            for s in range(g.shape[0]):
                t0 = _t.time()
                row = (jax.device_put(jnp.asarray(g[s])),
                       jax.device_put(jnp.asarray(o[s])),
                       jax.device_put(jnp.asarray(p[s])))
                jax.block_until_ready(row)
                nbytes = g[s].nbytes + o[s].nbytes + p[s].nbytes
                log.info("shard %d tables -> device: %.1f GB in %.0fs",
                         s, nbytes / (1 << 30), _t.time() - t0)
                rows.append(row)
            self._shard_list_cache = rows
        return self._shard_list_cache

    def _common_args(self, codes, lengths):
        cfg = self.cfg
        return (
            self._genome_dev, self._off_dev, self._pos_dev,
            jnp.asarray(codes), jnp.asarray(lengths, jnp.int32),
            self._matrices,
            jnp.int32(cfg.gap_read_penalty), jnp.int32(cfg.gap_ref_penalty),
            jnp.int32(cfg.gap_extend_penalty),
            jnp.float32(cfg.sensitivity), jnp.int32(cfg.max_kmer_freq),
            jnp.float32(cfg.min_identity), jnp.float32(cfg.min_residues),
        )

    def _statics(self):
        cfg = self.cfg
        return dict(
            k=cfg.kmer, fanout_cap=cfg.max_kmer_fanout,
            hit_cap=self.hit_cap, max_cmrs=cfg.max_cmrs,
            diag_bin_log2=cfg.diag_bin_log2, band=self.band,
            min_kmer_hits=max(1, cfg.kmer_min),
            read_stride=cfg.read_kmer_skip,
            bs=cfg.bs_mapping,
            bs_cutoff=cfg.bs_cutoff,
            end_to_end=cfg.end_to_end,
            packed_offsets=self._packed_offsets,
            canonical=self._canonical,
            simple_matrix=self._simple,
            word_cap=getattr(self, "word_cap", 0),
        )

    def _shard_tail_cap(self, B: int, paired: bool) -> int:
        """GLOBAL compacted-tail row budget for the sequential shard loop
        (0 = off: full per-shard tails).

        The budget is shared across ALL shards (_global_shard_tail): under
        the global threshold a read has candidates in ~1 shard, so 2B rows
        give 2x headroom over the batch REGARDLESS of how reads distribute
        over shards — per-shard budgets (the round-4 design) silently
        starved position-sorted input whose whole batch owns one shard.
        Total tail work equals the old S x 2B/S.  Overflow beyond the cap
        is counted in cmr_overflow.  NGM_SHARD_TAIL_CAP overrides the TOTAL
        (0 disables)."""
        import os as _os

        S = self.cfg.index_shards
        env = _os.environ.get("NGM_SHARD_TAIL_CAP")
        if env is not None:
            cap = int(env)
            if cap <= 0:
                return 0
        else:
            cap = max(1024, 2 * B)
        cap = -(-cap // 256) * 256          # round up: lane-friendly, even
        return 0 if cap >= S * B else cap

    # NGM_STAGED=always runs the step as TWO programs (cs_cands_step +
    # map_step_*_from_cands, byte-identical to the fused step by the
    # CandState invariant) instead of one; the default is the fused step.
    def _staged(self) -> bool:
        import os

        return os.environ.get("NGM_STAGED") == "always"

    def _map_staged(self, codes, lengths, paired: bool, pair_args=()):
        cfg = self.cfg
        reads = jnp.asarray(codes)
        lens = jnp.asarray(lengths, jnp.int32)
        sens = jnp.float32(cfg.sensitivity)
        statics = self._statics()
        c = cs_cands_step(
            self._genome_dev, self._off_dev, self._pos_dev, reads, lens,
            sens, jnp.int32(cfg.max_kmer_freq), **statics,
        )
        step = map_step_paired_from_cands if paired else map_step_from_cands
        return step(
            self._genome_dev, reads, lens, self._matrices,
            jnp.int32(cfg.gap_read_penalty), jnp.int32(cfg.gap_ref_penalty),
            jnp.int32(cfg.gap_extend_penalty), sens,
            jnp.float32(cfg.min_identity), jnp.float32(cfg.min_residues),
            *pair_args, c, c.best, **statics,
        )

    def map_batch(self, codes: np.ndarray, lengths: np.ndarray) -> MapResult:
        if self._sharded is not None:
            return self._map_sharded(codes, lengths, paired=False)
        if self.n_devices > 1:
            return self._dp_single(*self._common_args(codes, lengths))
        if self._staged():
            return self._map_staged(codes, lengths, paired=False)
        return map_step(*self._common_args(codes, lengths), **self._statics())

    def map_batch_topn(self, codes: np.ndarray, lengths: np.ndarray) -> tuple:
        topn = min(self.cfg.topn, self.cfg.max_cmrs)
        if self._sharded is not None:
            from nextgenmap_tpu.parallel.index_shard import merge_sharded_topn

            cfg = self.cfg
            reads = jnp.asarray(codes)
            lens = jnp.asarray(lengths, jnp.int32)
            sens = jnp.float32(cfg.sensitivity)
            mf = jnp.int32(cfg.max_kmer_freq)
            statics = self._statics()
            cands = [
                cs_cands_step(g, o, p, reads, lens, sens, mf, **statics)
                for (g, o, p) in self._shard_list()
            ]
            best = jnp.max(jnp.stack([c.best for c in cands]), axis=0)
            results = [
                map_step_topn_from_cands(
                    g, reads, lens, self._matrices,
                    jnp.int32(cfg.gap_read_penalty),
                    jnp.int32(cfg.gap_ref_penalty),
                    jnp.int32(cfg.gap_extend_penalty), sens,
                    jnp.float32(cfg.min_identity),
                    jnp.float32(cfg.min_residues),
                    c, best, topn=topn, **statics,
                )
                for (g, _, _), c in zip(self._shard_list(), cands)
            ]                                  # [S] of R-tuples of MapResult
            stk = MapResult(*[
                jnp.stack([
                    jnp.stack([getattr(shard_res[j], f) for j in range(topn)])
                    for shard_res in results
                ])
                for f in MapResult._fields
            ])                                 # fields [S, R, ...]
            return merge_sharded_topn(
                stk, self._base, self._clo, self._chi,
                topn=topn, read_len=self.read_len,
            )
        return map_step_topn(
            *self._common_args(codes, lengths),
            topn=topn,
            **self._statics(),
        )

    def supports_megabatch(self) -> bool:
        """map_batch_scan is valid on the plain one-device path and on the
        SEQUENTIAL sharded path (map_step_sharded_megascan; bisulfite is
        excluded — its dual-table fused program already stresses the
        compiler, and its default shard mode is the host loop).  The mesh
        paths have their own per-batch programs; topn/staged have bespoke
        tails."""
        seq_sharded = (
            self._sharded is not None
            and getattr(self, "_shard_args", None) == "seq"
            and not self.cfg.bs_mapping
        )
        return ((self._sharded is None or seq_sharded)
                and self.n_devices == 1 and not self._staged())

    def map_batch_scan(self, codes_k: np.ndarray, lengths_k: np.ndarray,
                       paired: bool = False) -> MapResult:
        """K stacked [B, L] batches in ONE dispatch (map_step_scan, or
        map_step_sharded_megascan on the sequential sharded path); fields
        come back stacked [K, ...].  Bit-identical per batch to map_batch."""
        cfg = self.cfg
        pair_args = ()
        if paired:
            pair_args = (
                jnp.int32(cfg.min_insert_size), jnp.int32(cfg.max_insert_size),
                jnp.float32(cfg.pair_score_cutoff),
            )
        if self._sharded is not None:
            scalars = (
                self._matrices,
                jnp.int32(cfg.gap_read_penalty), jnp.int32(cfg.gap_ref_penalty),
                jnp.int32(cfg.gap_extend_penalty),
                jnp.float32(cfg.sensitivity), jnp.int32(cfg.max_kmer_freq),
                jnp.float32(cfg.min_identity), jnp.float32(cfg.min_residues),
            )
            return map_step_sharded_megascan(
                *self._stack(), self._base, self._clo, self._chi,
                jnp.asarray(codes_k), jnp.asarray(lengths_k, jnp.int32),
                *scalars, *pair_args,
                paired=paired, read_len=self.read_len,
                compact_cap=self._shard_tail_cap(codes_k.shape[1], paired),
                **self._statics(),
            )
        return map_step_scan(
            *self._common_args(codes_k, lengths_k), *pair_args,
            paired=paired, **self._statics(),
        )

    def map_batch_paired(self, codes: np.ndarray, lengths: np.ndarray) -> MapResult:
        cfg = self.cfg
        pair_args = (
            jnp.int32(cfg.min_insert_size), jnp.int32(cfg.max_insert_size),
            jnp.float32(cfg.pair_score_cutoff),
        )
        if self._sharded is not None:
            return self._map_sharded(codes, lengths, paired=True,
                                     pair_args=pair_args)
        if self.n_devices > 1:
            return self._dp_paired(*self._common_args(codes, lengths), *pair_args)
        if self._staged():
            return self._map_staged(codes, lengths, paired=True,
                                    pair_args=pair_args)
        return map_step_paired(
            *self._common_args(codes, lengths), *pair_args, **self._statics(),
        )
