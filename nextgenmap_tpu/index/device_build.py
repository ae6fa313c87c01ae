"""Device-side (jitted) CSR k-mer index construction.

Reference analog: the two-pass CompactPrefixTable build
(ref:src/CompactPrefixTable.cpp) — "pass 1 counts per-kmer occurrences ->
offset array; pass 2 fills position lists" — which SURVEY.md §3.1 marks HOT
(whole-genome scan x2).  The host numpy build (kmer_index.py) mirrors that
design; this module is the device form: the two passes become a
scatter-add + cumsum + stable sort_key_val on device, so building the E. coli
index takes milliseconds instead of minutes and per-shard GRCh38 builds run
where the shard lives.

Representation difference vs the host build: over-frequent (repeat-masked)
rows are NOT physically removed — every enumerated k-mer position stays in
the positions array, and candidate search drops over-frequent rows at lookup
time via its max_freq argument (ops/candidate.py).  Invalid windows (N/pad,
stride phase) are routed to an overflow bucket 4^k that no lookup ever
touches.  CSR rows remain ascending (stable sort over position-ordered input)
so DESIGN.md rule 2 holds.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from nextgenmap_tpu.io.encode import CODE_A, CODE_C, CODE_G, CODE_T


@partial(jax.jit, static_argnames=("k", "skip", "collapse", "canonical"))
def build_index_device(
    genome: jax.Array,  # [G] uint8 codes
    *,
    k: int,
    skip: int,
    collapse: str = "none",
    canonical: bool = False,
):
    """Returns (offsets int32 [4^k + 2], positions int32 [Q]).

    offsets covers 4^k real buckets plus the invalid-window overflow bucket;
    Q = (G - k)//skip + 1 (static).  positions holds genome coordinates
    grouped by k-mer, ascending within each row.

    canonical=True keys each window by min(kmer, revcomp(kmer)) and stores
    ``(position << 1) | flip`` (flip = the revcomp form was smaller), so ONE
    read-side lookup serves both strands (ops/kmer.py
    extract_kmers_canonical; strand = read flip XOR stored flip).  Requires
    position < 2^30 to fit int32; callers fall back to the two-strand path
    for larger shards.  Incompatible with bisulfite collapse (the CT/GA
    collapses are strand-asymmetric).
    """
    G = genome.shape[0]
    if G >= (2**30 if canonical else 2**31):
        raise ValueError(
            f"genome of {G} bases too large for the int32 device index "
            "build; shard it (--index-shards)"
        )
    nb = 4**k
    Q = (G - k) // skip + 1
    c = genome.astype(jnp.int32)
    if collapse == "ct":
        c = jnp.where(c == CODE_C, CODE_T, c)
    elif collapse == "ga":
        c = jnp.where(c == CODE_G, CODE_A, c)
    else:
        assert collapse == "none", collapse
    assert not (canonical and collapse != "none"), "canonical excludes collapse"

    vals = jnp.zeros((Q,), dtype=jnp.int32)
    rvals = jnp.zeros((Q,), dtype=jnp.int32)
    ok = jnp.ones((Q,), dtype=bool)
    for j in range(k):
        w = jax.lax.slice(c, (j,), (j + (Q - 1) * skip + 1,), (skip,))
        vals = (vals << 2) | (w & 3)
        if canonical:
            rvals = rvals | ((3 - (w & 3)) << (2 * j))
        ok &= w < 4
    pos = jnp.arange(Q, dtype=jnp.int32) * skip
    if canonical:
        flip = (rvals < vals).astype(jnp.int32)
        vals = jnp.minimum(vals, rvals)
        pos = (pos << 1) | flip
    vals = jnp.where(ok, vals, nb)  # invalid windows -> overflow bucket

    counts = jnp.zeros((nb + 1,), jnp.int32).at[vals].add(1)
    offsets = jnp.concatenate([
        jnp.zeros((1,), jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)
    ])
    # stable sort keeps per-row positions ascending (DESIGN.md rule 2; with
    # canonical entries the encoded (pos<<1|flip) order equals pos order)
    _, positions = jax.lax.sort_key_val(vals, pos, is_stable=True)
    return offsets, positions
