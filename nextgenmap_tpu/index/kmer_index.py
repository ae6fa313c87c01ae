"""CSR k-mer index over the encoded genome.

Reference analog: ``CompactPrefixTable`` (ref:src/CompactPrefixTable.cpp),
the "CSSearchTable" of BASELINE.json: a hash table from 13-mers (k in
[10,14], stride --kmer-skip) to reference positions, built in two passes
(pass 1 counts per-kmer occurrences -> offset array, pass 2 fills position
lists), with over-frequent k-mers dropped (repeat masking), serialized to
disk next to the reference and mmap-reloaded.

Device form: direct-addressed CSR — ``offsets[4^k + 1]`` (int64 on host,
int32 on device) and a flat ``positions[]`` (uint32) — held as two device
arrays.  A lookup for a whole read batch is one vectorized gather; the
frequency cap at build time bounds per-kmer fan-out so the device-side gather
of the first ``max_kmer_fanout`` positions per k-mer stays a dense static
shape (SURVEY.md §2 component 7).

Bisulfite mode collapses C->T *at hashing time* (both in the genome pass and
in read k-mer extraction) so bisulfite-converted reads still hit their locus
(SURVEY.md §2 component 22).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from nextgenmap_tpu.io.encode import CODE_A, CODE_C, CODE_G, CODE_T
from nextgenmap_tpu.utils.logging import get_logger

log = get_logger("ngm-tpu.index")

INDEX_VERSION = 3  # v3: canonical entries (pos<<1|flip)
_CHUNK = 1 << 24  # genome positions per build chunk


def kmer_values(codes: np.ndarray, k: int, collapse: str = "none"):
    """Rolling k-mer values over a code array.

    Returns (values uint64 [n-k+1], valid bool [n-k+1]); windows containing
    any non-ACGT code are invalid.  collapse: "none" | "ct" (hash C as T,
    bisulfite forward pass) | "ga" (hash G as A, bisulfite rc pass).
    """
    n = codes.shape[0]
    if n < k:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
    c = codes.astype(np.uint64)
    if collapse == "ct":
        c = np.where(c == CODE_C, np.uint64(CODE_T), c)
    elif collapse == "ga":
        c = np.where(c == CODE_G, np.uint64(CODE_A), c)
    else:
        assert collapse == "none", collapse
    m = n - k + 1
    v = np.zeros(m, dtype=np.uint64)
    ok = np.ones(m, dtype=bool)
    for j in range(k):
        w = c[j : j + m]
        v = (v << np.uint64(2)) | (w & np.uint64(3))
        ok &= w < 4
    return v, ok


def kmer_values_canonical(codes: np.ndarray, k: int):
    """Rolling canonical k-mers: (canon uint64, flip uint8, valid bool).

    canon = min(kmer, revcomp(kmer)); flip = 1 where the revcomp form won.
    Mirrors ops/kmer.py::extract_kmers_canonical and the device index build.
    """
    n = codes.shape[0]
    if n < k:
        z = np.zeros(0, dtype=np.uint64)
        return z, np.zeros(0, np.uint8), np.zeros(0, dtype=bool)
    c = codes.astype(np.uint64)
    m = n - k + 1
    v = np.zeros(m, dtype=np.uint64)
    rv = np.zeros(m, dtype=np.uint64)
    ok = np.ones(m, dtype=bool)
    for j in range(k):
        w = c[j : j + m]
        v = (v << np.uint64(2)) | (w & np.uint64(3))
        rv = rv | ((np.uint64(3) - (w & np.uint64(3))) << np.uint64(2 * j))
        ok &= w < 4
    flip = (rv < v).astype(np.uint8)
    return np.minimum(v, rv), flip, ok


@dataclass
class KmerIndex:
    k: int
    skip: int
    max_freq: int
    collapse: str
    genome_sha1: str
    offsets: np.ndarray    # int64 [4^k + 1], CSR row offsets
    positions: np.ndarray  # uint32 [total], genome positions grouped by k-mer
                           # (canonical=True: (pos << 1) | flip entries)
    canonical: bool = False

    @property
    def n_buckets(self) -> int:
        return 4**self.k

    def lookup(self, kmer: int) -> np.ndarray:
        """Positions for one k-mer value (host-side; tests/debug)."""
        return self.positions[self.offsets[kmer] : self.offsets[kmer + 1]]

    def device_arrays(self):
        """(offsets int32 [4^k+1], positions int32 [total]) for HBM residence.

        int32 is safe while total positions < 2^31 and genome < 2^31; larger
        genomes are handled by position-range sharding (parallel/sharding.py)
        where each shard re-bases positions into its own int32 range.
        """
        if self.positions.shape[0] >= 2**31 or (
            self.positions.shape[0] and int(self.positions.max()) >= 2**31
        ):
            raise ValueError("index too large for single-shard int32; shard it")
        return self.offsets.astype(np.int32), self.positions.astype(np.int32)

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        genome_codes: np.ndarray,
        k: int = 13,
        skip: int = 2,
        max_freq: int = 1000,
        collapse: str = "none",
        genome_sha1: str = "",
        canonical: bool = False,
        allow_u32: bool = False,
    ) -> "KmerIndex":
        """Two-pass CSR build — native C passes when available (seconds for a
        gigabase genome, ref:src/CompactPrefixTable.cpp analog), vectorized
        numpy otherwise (byte-identical arrays; asserted in tests).

        allow_u32: keep canonical (pos<<1|flip) entries up to genome 2^31 —
        for consumers that never place the GLOBAL table on device (position-
        range sharding rebases per-shard entries into int32; sharding is what
        makes canonical usable at gigabase scale, not the other way around).
        """
        assert not (canonical and collapse != "none"), "canonical excludes collapse"
        if canonical and genome_codes.shape[0] >= (2**31 if allow_u32 else 2**30):
            canonical = False  # (pos<<1) must fit int32 on device
        n = genome_codes.shape[0]
        nb = 4**k

        from nextgenmap_tpu import native

        if native.lib() is not None:
            t0 = __import__("time").time()
            counts = native.index_count(genome_codes, k, skip, collapse, canonical)
            dropped = counts > max_freq
            n_dropped = int(dropped.sum())
            counts[dropped] = 0
            offsets = np.zeros(nb + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            total = int(offsets[-1])
            positions = native.index_fill(
                genome_codes, k, skip, collapse, canonical, dropped,
                offsets, total,
            )
            log.info(
                "index built (native): k=%d skip=%d, %d positions, "
                "%d k-mers repeat-masked, %.1fs",
                k, skip, total, n_dropped, __import__("time").time() - t0,
            )
            return cls(
                k=k, skip=skip, max_freq=max_freq, collapse=collapse,
                genome_sha1=genome_sha1, offsets=offsets, positions=positions,
                canonical=canonical,
            )

        counts = np.zeros(nb, dtype=np.int64)

        def chunks():
            for start in range(0, n, _CHUNK):
                stop = min(n, start + _CHUNK + k - 1)
                if canonical:
                    v, flips, ok = kmer_values_canonical(genome_codes[start:stop], k)
                else:
                    v, ok = kmer_values(genome_codes[start:stop], k, collapse)
                    flips = None
                if v.shape[0] == 0:
                    continue
                # global stride: keep positions where (start + i) % skip == 0
                i0 = (-start) % skip
                sel = np.zeros(v.shape[0], dtype=bool)
                sel[i0::skip] = True
                sel &= ok
                idx = np.nonzero(sel)[0]
                yield start, v[idx], idx, (flips[idx] if flips is not None else None)

        # pass 1: count (bincount ~10x faster than np.add.at scatter)
        for _, v, _, _ in chunks():
            counts += np.bincount(v.astype(np.int64), minlength=nb)
        # repeat masking: drop k-mers above the frequency cap entirely
        dropped = counts > max_freq
        n_dropped = int(dropped.sum())
        counts[dropped] = 0
        offsets = np.zeros(nb + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        total = int(offsets[-1])
        positions = np.empty(total, dtype=np.uint32)
        # pass 2: fill (positions appended in genome order per k-mer, so each
        # CSR row is sorted ascending — the determinism spec relies on this)
        cursor = offsets[:-1].copy()
        for start, v, idx, flips in chunks():
            vi = v.astype(np.int64)
            keep = ~dropped[vi]
            vi = vi[keep]
            pos = (start + idx[keep]).astype(np.uint32)
            if canonical:
                pos = (pos << np.uint32(1)) | flips[keep].astype(np.uint32)
            # stable per-chunk counting-sort insert (fully vectorized)
            order = np.argsort(vi, kind="stable")
            vi = vi[order]
            pos = pos[order]
            m = vi.shape[0]
            if m == 0:
                continue
            is_new = np.empty(m, dtype=bool)
            is_new[0] = True
            is_new[1:] = vi[1:] != vi[:-1]
            ar = np.arange(m, dtype=np.int64)
            group_start = np.maximum.accumulate(np.where(is_new, ar, 0))
            rank = ar - group_start
            positions[cursor[vi] + rank] = pos
            uniq, ucount = np.unique(vi, return_counts=True)
            cursor[uniq] += ucount
        assert np.array_equal(cursor, offsets[1:]), "CSR fill mismatch"
        log.info(
            "index built: k=%d skip=%d, %d positions, %d k-mers repeat-masked",
            k, skip, total, n_dropped,
        )
        return cls(
            k=k, skip=skip, max_freq=max_freq, collapse=collapse,
            genome_sha1=genome_sha1, offsets=offsets, positions=positions,
            canonical=canonical,
        )

    # -- memoization (ref: <ref>-ht-<k>-<skip>.<v>.ngm artifacts) --
    @staticmethod
    def cache_path(fasta_path: str, k: int, skip: int, collapse: str = "none",
                   canonical: bool = False) -> str:
        cs = "" if collapse == "none" else f"-{collapse}"
        cn = "-canon" if canonical else ""
        return f"{fasta_path}.ngmt-ht-{k}-{skip}{cs}{cn}.v{INDEX_VERSION}.npz"

    def save(self, path: str) -> None:
        meta = {
            "version": INDEX_VERSION, "k": self.k, "skip": self.skip,
            "max_freq": self.max_freq, "collapse": self.collapse,
            "genome_sha1": self.genome_sha1, "canonical": self.canonical,
        }
        # atomic: concurrent processes (cross-host sharding on one fs) may
        # memoize the same cache; tmp+rename keeps readers from seeing a
        # half-written npz
        tmp = f"{path}.tmp{os.getpid()}.npz"
        np.savez(
            tmp, offsets=self.offsets, positions=self.positions,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        )
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "KmerIndex":
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta["version"] != INDEX_VERSION:
                raise ValueError("index version mismatch")
            return cls(
                k=meta["k"], skip=meta["skip"], max_freq=meta["max_freq"],
                collapse=meta["collapse"], genome_sha1=meta["genome_sha1"],
                offsets=z["offsets"], positions=z["positions"],
                canonical=meta.get("canonical", False),
            )

    @classmethod
    def open(
        cls, fasta_path: str, genome_codes: np.ndarray, genome_sha1: str,
        k: int, skip: int, max_freq: int, collapse: str = "none",
        skip_save: bool = False, canonical: bool = False,
        allow_u32: bool = False,
    ) -> "KmerIndex":
        cache = cls.cache_path(fasta_path, k, skip, collapse, canonical)
        if os.path.exists(cache):
            idx = cls.load(cache)
            if idx.genome_sha1 == genome_sha1 and idx.max_freq == max_freq:
                log.info("loaded k-mer index from %s", cache)
                return idx
            log.warning("stale index cache (genome or params changed); rebuilding")
        idx = cls.build(genome_codes, k, skip, max_freq, collapse, genome_sha1,
                        canonical=canonical, allow_u32=allow_u32)
        if not skip_save:
            try:
                idx.save(cache)
            except OSError as e:
                log.warning("could not memoize index: %s", e)
        return idx
