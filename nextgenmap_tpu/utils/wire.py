"""Single-buffer device->host wire format for result pytrees.

Every fetched device buffer is its own device-to-host copy: a MapResult is
17 leaves, so a per-leaf fetch makes 17 copies of a ~1 MB payload.  This
module packs any pytree of device arrays into ONE flat uint8 buffer with a
tiny jitted concat program, starts ONE async copy, and hands back the same
tree shape filled with lazy host views — emit code keeps calling
np.asarray(field) and never knows.

Bit-exact: every leaf is bitcast (never converted) to bytes; host views
reinterpret the same bytes at the recorded offset/shape/dtype.

(reference analog: none — the upstream C++ runtime shares one address
space; this replaces its zero-copy result buffers)
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp


def _leaf_spec(x) -> tuple:
    return (tuple(x.shape), jnp.dtype(x.dtype).name)


_PACKERS: dict[tuple, Any] = {}


def _build_packer(spec: tuple):
    """Jitted [leaves] -> one flat uint8 buffer (bitcast + concat)."""

    def pack(leaves):
        parts = []
        for x in leaves:
            if x.dtype == jnp.bool_:
                x = x.astype(jnp.uint8)
            b = jax.lax.bitcast_convert_type(x, jnp.uint8)
            parts.append(b.reshape(-1))
        return jnp.concatenate(parts) if parts else jnp.zeros((0,), jnp.uint8)

    return jax.jit(pack)


def _offsets(spec: tuple) -> list[tuple[int, int]]:
    offs = []
    at = 0
    for shape, dtype in spec:
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(
            "uint8" if dtype == "bool" else dtype
        ).itemsize
        offs.append((at, nbytes))
        at += nbytes
    return offs


class _WireBuf:
    """One packed device buffer; host copy materialized once, lazily."""

    def __init__(self, dev_buf, spec):
        self._dev = dev_buf
        self._spec = spec
        self._offs = _offsets(spec)
        self._host: np.ndarray | None = None
        self._lock = threading.Lock()
        try:
            dev_buf.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass

    def host(self) -> np.ndarray:
        with self._lock:
            if self._host is None:
                self._host = np.asarray(self._dev)
                self._dev = None  # free the device buffer reference
            return self._host

    def view(self, i: int) -> np.ndarray:
        shape, dtype = self._spec[i]
        off, nbytes = self._offs[i]
        raw = self.host()[off:off + nbytes]
        if dtype == "bool":
            return raw.view(np.uint8).astype(bool).reshape(shape)
        return raw.view(np.dtype(dtype)).reshape(shape)


class WireLeaf:
    """Lazy stand-in for one fetched leaf; np.asarray()/int() trigger the
    (shared, once-only) host materialization of the whole buffer."""

    __slots__ = ("_buf", "_i", "_cache")

    def __init__(self, buf: _WireBuf, i: int):
        self._buf = buf
        self._i = i
        self._cache = None

    def _np(self) -> np.ndarray:
        if self._cache is None:
            self._cache = self._buf.view(self._i)
        return self._cache

    def __array__(self, dtype=None, copy=None):
        a = self._np()
        return a.astype(dtype) if dtype is not None else a

    def __int__(self):
        return int(self._np())

    def __getitem__(self, k):
        return self._np()[k]

    @property
    def shape(self):
        return self._buf._spec[self._i][0]

    @property
    def dtype(self):
        return np.dtype(self._buf._spec[self._i][1])


def fetch_packed(res):
    """Pack a result pytree into ONE device buffer, start its async copy,
    and return the same tree shape with WireLeaf placeholders.

    Adds one tiny device program per batch (elementwise copies); removes
    len(leaves)-1 fetch round-trips.  Falls back to the caller's plain
    path by raising only on pack-compile failure (caller catches)."""
    leaves, treedef = jax.tree_util.tree_flatten(res)
    spec = tuple(_leaf_spec(x) for x in leaves)
    packer = _PACKERS.get(spec)
    if packer is None:
        packer = _PACKERS[spec] = _build_packer(spec)
    buf = _WireBuf(packer(leaves), spec)
    return jax.tree_util.tree_unflatten(
        treedef, [WireLeaf(buf, i) for i in range(len(leaves))]
    )
