"""Device mesh construction.

Reference analog: none — the reference is single-node pthreads
(ref:src/NGMThreads.cpp); this layer is a new capability of this build
(SURVEY.md §2.3, §5.8).  Meshes:

- 1-D ("dp",): data parallelism over reads — configs 1-3.
- 2-D ("dp", "ish"): reads sharded over dp, the k-mer index + genome sharded
  by position range over ish — config 4 (GRCh38 across hosts/devices).

Devices are taken in jax order; the mesh follows the algorithm only (the
devices of one host are joined all to all).  Multi-host: call
jax.distributed.initialize() before make_mesh(); jax.devices() then spans
every host and the same code paths apply (XLA's collective lowering).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, index_shards: int = 1,
              devices=None) -> Mesh:
    """1-D reads mesh, or 2-D (dp, ish) when index_shards > 1.

    Defaults to this process's LOCAL devices: data-parallel mapping feeds
    each host its own read shard (parallel/distributed.py), so the dp mesh
    must not span hosts.  Pass `devices=jax.devices()` explicitly to build a
    global mesh (pod-sharded index over "ish").
    """
    devs = jax.local_devices() if devices is None else devices
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    devs = np.asarray(devs[:n])
    if index_shards <= 1:
        return Mesh(devs.reshape(n), ("dp",))
    if n % index_shards:
        raise ValueError(f"{n} devices not divisible by {index_shards} index shards")
    return Mesh(devs.reshape(n // index_shards, index_shards), ("dp", "ish"))
