"""Multi-host mapping: per-host read sharding + deterministic output merge.

Reference analog: none — NextGenMap is strictly single-node (SURVEY.md §2.2:
"Multi-node / distributed: NO"); this is a new capability of this build
(SURVEY.md §2.3, §5.8).  The design exploits that read mapping is
embarrassingly parallel over reads:

- Every process (host) streams the same input files but maps only the read
  batches whose index is ≡ its process id (mod nprocs) — round-robin BLOCK
  sharding at batch granularity, so no process coordination is needed on the
  hot path and any process count yields the same per-read results.
- Each process writes its records to ``<out>.part<i>-of-<n>`` plus a manifest
  sidecar recording per-batch record counts; the merge step re-interleaves
  the parts round-robin into the exact single-process output (DESIGN.md rule
  14: SAM order == input order, byte-identical for any shard count).
- Within a process, mapping still shards over the local devices via the
  "dp" mesh (parallel/dp.py).  Cross-host collectives are only needed when
  the INDEX is sharded across hosts (parallel/index_shard.py over a global
  mesh) — for that, `init_distributed` brings up `jax.distributed` so
  `jax.devices()` spans every host's devices (SURVEY.md §5.8).
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Iterator

from nextgenmap_tpu.utils.logging import get_logger

log = get_logger("ngm-tpu.dist")


def init_distributed(coordinator: str, num_processes: int, process_id: int) -> None:
    """Bring up jax.distributed so jax.devices() spans all hosts.

    Only required for cross-host collectives (index sharding across hosts);
    plain data-parallel multi-host mapping needs no global runtime at all.
    """
    import jax

    try:
        # multi-process CPU meshes (tests; SURVEY.md §4 item 6) need a CPU
        # collectives implementation; GPUs use their own (NCCL)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:  # older/newer jax without the option
        pass
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    log.info(
        "jax.distributed up: process %d/%d, %d global / %d local devices",
        process_id, num_processes, len(jax.devices()), len(jax.local_devices()),
    )


def shard_batches(batches: Iterator, procid: int, nprocs: int) -> Iterator:
    """Yield only the batches owned by this process (round-robin by index)."""
    for i, b in enumerate(batches):
        if i % nprocs == procid:
            yield b


def part_path(out_path: str, procid: int, nprocs: int) -> str:
    return f"{out_path}.part{procid}-of-{nprocs}"


def manifest_path(out_path: str, procid: int, nprocs: int) -> str:
    return part_path(out_path, procid, nprocs) + ".manifest.json"


class CountingWriter:
    """Text-stream wrapper counting emitted lines AND bytes (records are one
    line; byte counts let the merge bulk-copy batch runs with f.read(n)
    instead of a Python readline per record)."""

    def __init__(self, out: IO[str], lines: int = 0, nbytes: int = 0):
        self.out = out
        self.lines = lines
        self.nbytes = nbytes

    def write(self, s: str) -> int:
        self.lines += s.count("\n")
        self.nbytes += len(s)
        return self.out.write(s)

    def flush(self) -> None:
        self.out.flush()

    def close(self) -> None:
        self.out.close()


def write_manifest(out_path: str, procid: int, nprocs: int,
                   header_lines: int, batch_lines: list[int],
                   stats_dict: dict, complete: bool,
                   batch_bytes: list[int] | None = None) -> None:
    mp = manifest_path(out_path, procid, nprocs)
    tmp = mp + ".tmp"
    with open(tmp, "w") as f:
        json.dump({
            "procid": procid, "nprocs": nprocs,
            "header_lines": header_lines,
            "batch_lines": batch_lines,
            "batch_bytes": batch_bytes,
            "stats": stats_dict,
            "complete": complete,
        }, f)
    os.replace(tmp, mp)


def _wait_for_manifests(out_path: str, nprocs: int, timeout: float) -> list[dict]:
    """Poll until every part's manifest exists and is complete."""
    deadline = time.time() + timeout
    manifests: list[dict | None] = [None] * nprocs
    while True:
        for i in range(nprocs):
            if manifests[i] is not None:
                continue
            mp = manifest_path(out_path, i, nprocs)
            if os.path.exists(mp):
                try:
                    m = json.load(open(mp))
                except (OSError, ValueError):
                    continue
                if m.get("complete"):
                    manifests[i] = m
        if all(m is not None for m in manifests):
            return manifests  # type: ignore[return-value]
        if time.time() > deadline:
            missing = [i for i, m in enumerate(manifests) if m is None]
            raise TimeoutError(
                f"timed out waiting for output shards {missing} of {out_path}"
            )
        time.sleep(0.5)


def merge_parts(out_path: str, nprocs: int, timeout: float = 3600.0,
                keep_parts: bool = False, bam: bool = False) -> dict:
    """Merge ``<out>.part*`` into ``out_path``, restoring input read order.

    Batches were dealt round-robin (batch b -> process b % nprocs), so the
    merge interleaves the parts' per-batch runs in that same order — as BULK
    byte copies (each part's manifest records per-batch byte counts), so a
    10M-read merge streams at IO speed instead of a Python readline per
    record.  With bam=True the merged text is encoded through BamTextWriter
    (parts are always SAM text).  Returns the summed stats dict.  Runs on ONE
    process (id 0) after all manifests report complete — a shared filesystem
    is assumed, as is standard for pod workloads.
    """
    manifests = _wait_for_manifests(out_path, nprocs, timeout)
    parts = [open(part_path(out_path, i, nprocs), "r", buffering=1 << 20)
             for i in range(nprocs)]
    if bam:
        from nextgenmap_tpu.io.bam import BamTextWriter

        out = BamTextWriter(out_path)
    else:
        out = open(out_path, "w", buffering=1 << 20)
    try:
        # header comes from part 0; other parts' headers are skipped
        for i, (m, f) in enumerate(zip(manifests, parts)):
            for _ in range(m["header_lines"]):
                line = f.readline()
                if i == 0:
                    out.write(line)
        sizes = [m.get("batch_bytes") or m["batch_lines"] for m in manifests]
        by_bytes = [m.get("batch_bytes") is not None for m in manifests]
        cursor = [0] * nprocs
        b = 0
        while True:
            p = b % nprocs
            if cursor[p] >= len(sizes[p]):
                # this part is drained; the global batch sequence ends at
                # the first missing owner
                break
            n = sizes[p][cursor[p]]
            if by_bytes[p]:
                out.write(parts[p].read(n))
            else:  # legacy line-count manifest
                for _ in range(n):
                    out.write(parts[p].readline())
            cursor[p] += 1
            b += 1
    finally:
        for f in parts:
            f.close()
        out.close()
    totals: dict = {}
    for m in manifests:
        for k, v in m["stats"].items():
            if isinstance(v, (int, float)):
                totals[k] = totals.get(k, 0) + v
    if not keep_parts:
        for i in range(nprocs):
            os.remove(part_path(out_path, i, nprocs))
            os.remove(manifest_path(out_path, i, nprocs))
    log.info("merged %d output shards into %s", nprocs, out_path)
    return totals
