"""Contiguous-window gathers — the memory-access idiom of the whole mapper.

Reference analog: NGM's two hot random-access patterns — CSR position-list
reads in the candidate-search loop (ref:src/CS.cpp) and corridor extraction
from the encoded genome (ref:src/SequenceProvider.cpp DecodeRefInternal).
Both read a short CONTIGUOUS run of elements at a computed offset.

Device form: instead of `table[starts[..., None] + iota(K)]` (one gather
index per ELEMENT), one `lax.gather` with `slice_sizes=(K,)` pulls K
contiguous elements per index.  Tables are padded by the
window size so starts never need clamping (a clamped start would silently
shift the window and corrupt valid lanes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def gather_windows(table: jax.Array, starts: jax.Array, size: int) -> jax.Array:
    """Gather `size` contiguous elements of 1-D `table` at each of `starts`.

    Args:
      table: [P] array, already padded so that max(starts) + size <= P
             (see pad_table).  Starts are still clamped defensively.
      starts: integer array of any shape [...].
      size: static window length.

    Returns:
      [..., size] windows, table[starts[i] : starts[i]+size] per index.
    """
    P = table.shape[0]
    sh = starts.shape
    idx = jnp.clip(starts, 0, P - size).reshape(-1, 1)
    dn = lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(), start_index_map=(0,)
    )
    out = lax.gather(
        table, idx, dn, slice_sizes=(size,),
        mode=lax.GatherScatterMode.PROMISE_IN_BOUNDS,
    )
    return out.reshape(*sh, size)


def pad_table(table: jax.Array, size: int, fill) -> jax.Array:
    """Pad a 1-D table by `size` fill elements so window gathers never clamp."""
    return jnp.concatenate(
        [table, jnp.full((size,), fill, table.dtype)]
    )


def permute_small(values: jax.Array, order: jax.Array) -> jax.Array:
    """values[b, order[b, i]] for small trailing dims, without a gather.

    [B, C] x [B, C] -> [B, C] via a one-hot select-sum (C^2 elementwise
    work per row, for C up to a few hundred).
    """
    B, C = values.shape
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (B, C, C), 2) == order[:, :, None]
    )
    return jnp.sum(
        jnp.where(onehot, values[:, None, :], 0), axis=2
    ).astype(values.dtype)


def take_rows_mxu(stack: jax.Array, rows: jax.Array) -> jax.Array:
    """stack[rows[m], :] for small-code uint8 tables, as one matmul.

    A one-hot [M, N] bf16 matmul against the [N, L] table replaces M
    per-row gathers.  Exact: one-hot entries and codes 0..4 are exact in
    bf16, accumulation is f32 and each output element sums exactly one
    nonzero product.  Chosen on another chip; not measured against
    `jnp.take` on the H100 end to end.
    """
    N = stack.shape[0]
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (rows.shape[0], N), 1)
        == rows[:, None]
    ).astype(jnp.bfloat16)
    out = jax.lax.dot_general(
        onehot, stack.astype(jnp.bfloat16),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return out.astype(jnp.uint8)


def select_rows(stack: jax.Array, sel: jax.Array) -> jax.Array:
    """stack[b, sel[b], :] without an element-serial gather.

    stack: [B, C, ...], sel: [B] int — returns [B, ...] via a one-hot
    mask-and-sum (elementwise work; C is small).
    """
    B, C = stack.shape[:2]
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (B, C), 1) == sel[:, None]
    )
    mask = onehot.reshape(B, C, *([1] * (stack.ndim - 2)))
    return jnp.sum(jnp.where(mask, stack, 0), axis=1).astype(stack.dtype)
