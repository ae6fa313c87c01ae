"""Index sharding by genome-position range + cross-shard result merge.

Reference analog: none — the reference holds one index per process
(ref:src/CompactPrefixTable.cpp).  This is the TP-analog capability of
SURVEY.md §2.2: for genomes too big for one device (GRCh38, BASELINE config
4), the CSR k-mer table and the genome are split into S contiguous position
ranges; reads are replicated across the "ish" mesh axis, every shard runs
the full local pipeline against its range, and per-shard best hits are merged
with all_gather + lexicographic argmax — exactly the north-star sentence
"per-shard best-hit candidates and alignment scores merged via
all-gather/reduce collectives before SAM emission".

Determinism (DESIGN.md rule 15): each shard has a halo (>= corridor + read
length + max insert) so boundary loci are fully alignable, but a shard only
*owns* results whose position falls in its core range — halo duplicates are
masked out before the merge, and the merge key (score DESC, strand fwd
first, position ASC, shard ASC) makes the output independent of S.

Positions inside a shard are rebased to local int32, which is what makes
>2^31-base genomes (GRCh38 concatenated) addressable: no global int64
arithmetic ever runs on device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from nextgenmap_tpu.config import NgmConfig
from nextgenmap_tpu.index.kmer_index import KmerIndex
from nextgenmap_tpu.io.encode import PAD
from nextgenmap_tpu.models.mapper import MapResult, map_step, map_step_paired

INT_MAX = np.int32(2**31 - 1)
# global positions ride uint32 on device (GRCh38 concatenated exceeds int31)
UPOS_MAX = np.uint32(2**32 - 1)  # numpy, not jnp: no XLA init at import


def shard_ranges(G: int, n_shards: int, halo: int):
    """Per-shard (lo, hi, core_l, core_h) over the standard contiguous split.
    The single definition every builder/loader derives ranges from, so a
    subset build (cross-host) pads to the same shapes as a full build."""
    span = -(-G // n_shards)
    out = []
    for s in range(n_shards):
        core_l, core_h = s * span, min(G, (s + 1) * span)
        out.append((max(0, core_l - halo), min(G, core_h + halo),
                    core_l, core_h))
    return out


def _shard_pos_counts(positions: np.ndarray, G: int, n_shards: int,
                      halo: int, canonical: bool = False) -> np.ndarray:
    """Exact per-shard CSR entry counts (positions in [lo, hi)) in ONE
    histogram pass: shard ranges overlap by the halo, so counts come from
    non-overlapping boundary intervals summed per shard.  This is what lets
    a host that builds ONLY its own shard still pad to the global max width
    (all processes must agree on array shapes for the global mesh).

    canonical: entries are (pos << 1) | flip — monotone in pos, so doubling
    the bin edges ranges over the same position intervals."""
    ranges = shard_ranges(G, n_shards, halo)
    mul = 2 if canonical else 1
    edges = np.unique(
        np.array([b * mul for lo, hi, _, _ in ranges for b in (lo, hi)],
                 np.int64)
    )
    hist, _ = np.histogram(positions, bins=edges)
    cum = np.zeros(edges.shape[0], np.int64)
    np.cumsum(hist, out=cum[1:])
    at = lambda x: cum[np.searchsorted(edges, x * mul)]
    return np.array([at(hi) - at(lo) for lo, hi, _, _ in ranges], np.int64)


def _slice_csr_shards(index: KmerIndex, G: int, n_shards: int, halo: int,
                      shard_ids=None):
    """Slice one global CSR into per-shard (offsets int32, local positions
    int32) lists over the standard shard ranges.  Reuses the global CSR so
    repeat masking stays globally consistent — a shard never resurrects a
    globally over-frequent k-mer, which would break shard-count invariance.
    shard_ids selects a subset (cross-host: each host slices only its own).

    Canonical CSRs ((pos << 1) | flip entries, monotone in pos) slice with
    DOUBLED bounds; the rebase `entry - (lo << 1)` keeps the flip bit and
    yields local canonical entries — which is what makes canonical k-mer
    lookup (one gather serves both strands, the round-1 CS win) usable at
    gigabase scale: per-shard local entries fit int32 even when the global
    (pos << 1) would not."""
    from nextgenmap_tpu import native

    mul = 2 if index.canonical else 1
    nb = index.n_buckets
    use_native = native.lib() is not None
    if not use_native:
        row_id = np.repeat(
            np.arange(nb, dtype=np.int64), np.diff(index.offsets)
        )
        pos_all = index.positions.astype(np.int64)

    ranges = shard_ranges(G, n_shards, halo)
    offs, poss = [], []
    for s in (range(n_shards) if shard_ids is None else shard_ids):
        lo, hi, _, _ = ranges[s]
        if use_native:
            # streams the CSR once per shard in C (the numpy repeat/
            # bincount route needs ~10 min + ~20 GB at 1.2B entries)
            off, local = native.shard_csr(index.offsets, index.positions,
                                          lo * mul, hi * mul)
        else:
            m = (pos_all >= lo * mul) & (pos_all < hi * mul)
            counts = np.bincount(row_id[m], minlength=nb)
            off = np.zeros(nb + 1, dtype=np.int64)
            np.cumsum(counts, out=off[1:])
            local = (pos_all[m] - lo * mul).astype(np.int32)
        offs.append(off.astype(np.int32))
        poss.append(local)
    return offs, poss


@dataclass
class ShardedIndex:
    """Host-side container of per-shard genome slices + CSR tables, stacked
    along a leading shard axis so shard_map can split them over "ish".

    Note: stacking materializes all shards on one host — fine for tests and
    single-host runs; multi-host pods construct only their own shard(s) and
    feed them via per-host jax.make_array_from_single_device_arrays.
    """

    n_shards: int
    genome: np.ndarray      # [S', Gs] uint8 (PAD-padded slices)
    offsets: np.ndarray     # [S', 4^k+1] int32 (dual: [S', 2*(4^k+1)])
    positions: np.ndarray   # [S', Pmax] int32 (local coords, 0-padded)
    base: np.ndarray        # [S] uint32 global position of slice start
    core_lo: np.ndarray     # [S] uint32 ownership range
    core_hi: np.ndarray     # [S] uint32  (genome must be < 2^32 bases)
    max_freq: int = 0       # repeat-mask cap baked into the shard CSRs
    dual: bool = False      # bisulfite: CT + GA collapsed tables concatenated
                            # per shard (models/mapper.py dual-table layout)
    canonical: bool = False  # positions are local (pos << 1) | flip entries
                             # (one lookup serves both strands)
    shard_ids: np.ndarray | None = None
                            # cross-host subset: the global shard ids the S'
                            # rows of genome/offsets/positions hold (base/
                            # core_lo/core_hi stay full [S]); None = all S.
                            # Padded widths Gs/Pmax are GLOBAL maxima either
                            # way, so every host agrees on array shapes.

    @classmethod
    def build(
        cls, index: KmerIndex, genome_codes: np.ndarray, n_shards: int,
        halo: int, shard_ids=None,
    ) -> "ShardedIndex":
        """Split a built global index into position-range shards.

        Reuses the global CSR (so repeat masking stays globally consistent —
        a shard never resurrects a globally over-frequent k-mer, which would
        break shard-count invariance).  shard_ids: build only those shards
        (cross-host; VERDICT r2 missing #3) — padding still uses global
        counts so all hosts produce mesh-compatible shapes.
        """
        G = genome_codes.shape[0]
        offs, poss = _slice_csr_shards(index, G, n_shards, halo, shard_ids)
        pm = None
        if shard_ids is not None:
            pm = int(
                _shard_pos_counts(index.positions, G, n_shards, halo,
                                  canonical=index.canonical).max()
            )
        return cls._assemble(genome_codes, n_shards, halo, offs, poss,
                             index.max_freq, dual=False,
                             shard_ids=shard_ids, pm_global=pm,
                             canonical=index.canonical)

    @classmethod
    def build_dual(
        cls, index_ct: KmerIndex, index_ga: KmerIndex,
        genome_codes: np.ndarray, n_shards: int, halo: int, shard_ids=None,
    ) -> "ShardedIndex":
        """Bisulfite sharding: slice BOTH collapsed CSRs by the same position
        ranges, then concatenate per shard exactly like the unsharded
        dual-table layout (models/mapper.py: offsets = [ct | ga + n_ct],
        positions = [ct | ga]) so map_step's table_split lookup works
        unchanged against each shard."""
        G = genome_codes.shape[0]
        offs_ct, poss_ct = _slice_csr_shards(index_ct, G, n_shards, halo,
                                             shard_ids)
        offs_ga, poss_ga = _slice_csr_shards(index_ga, G, n_shards, halo,
                                             shard_ids)
        offs = [
            np.concatenate([o1, o2 + np.int32(p1.shape[0])])
            for o1, o2, p1 in zip(offs_ct, offs_ga, poss_ct)
        ]
        poss = [
            np.concatenate([p1, p2]) for p1, p2 in zip(poss_ct, poss_ga)
        ]
        pm = None
        if shard_ids is not None:
            pm = int((
                _shard_pos_counts(index_ct.positions, G, n_shards, halo)
                + _shard_pos_counts(index_ga.positions, G, n_shards, halo)
            ).max())
        return cls._assemble(genome_codes, n_shards, halo, offs, poss,
                             index_ct.max_freq, dual=True,
                             shard_ids=shard_ids, pm_global=pm)

    @classmethod
    def _assemble(cls, genome_codes, n_shards, halo, offs, poss, max_freq,
                  dual, shard_ids=None, pm_global=None, canonical=False):
        G = genome_codes.shape[0]
        ranges = shard_ranges(G, n_shards, halo)
        bases = [lo for lo, _, _, _ in ranges]
        clo = [cl for _, _, cl, _ in ranges]
        chi = [ch for _, _, _, ch in ranges]
        own = list(range(n_shards)) if shard_ids is None else list(shard_ids)
        slices = [genome_codes[ranges[s][0]:ranges[s][1]] for s in own]
        # padded widths must be the GLOBAL maxima (identical on every host)
        gs = max(hi - lo for lo, hi, _, _ in ranges)
        pm = max(1, max((x.shape[0] for x in poss), default=1)
                 if pm_global is None else pm_global)
        genome = np.full((len(own), gs), PAD, dtype=np.uint8)
        positions = np.zeros((len(own), pm), dtype=np.int32)
        for i in range(len(own)):
            genome[i, : slices[i].shape[0]] = slices[i]
            positions[i, : poss[i].shape[0]] = poss[i]
        return cls(
            n_shards=n_shards,
            genome=genome,
            offsets=np.stack(offs),
            positions=positions,
            base=np.asarray(bases, np.uint32),
            core_lo=np.asarray(clo, np.uint32),
            core_hi=np.asarray(chi, np.uint32),
            max_freq=max_freq,
            dual=dual,
            canonical=canonical,
            shard_ids=None if shard_ids is None else np.asarray(own, np.int32),
        )

    # the framework's supported read-length ceiling (ref supports ~36-1000 bp)
    MAX_READ_LEN = 1024

    @staticmethod
    def halo_for(cfg: NgmConfig, read_len: int = 0, paired: bool = True) -> int:
        """Shard overlap so boundary loci are fully alignable + pairable.

        Deliberately READ-LENGTH-INDEPENDENT (sized for MAX_READ_LEN): the
        halo only has to be >= the needed span, results are invariant to its
        size (ownership is by core range), and a fixed halo lets `ngm-tpu
        index --index-shards N` pre-build the artifact before any reads are
        seen.  The argument is kept for signature compatibility; a few kb of
        extra overlap per shard is noise against gigabase shard spans.
        """
        L = ShardedIndex.MAX_READ_LEN
        h = L + cfg.corridor_for(L)
        if paired:
            h += cfg.max_insert_size
        return h

    # -- memoization (the shard split of a gigabase CSR costs minutes; the
    # artifact reloads in seconds, like the reference's .ngm files) --
    SHARDS_VERSION = 2  # v2: dual (bisulfite) flag in meta

    @staticmethod
    def cache_path(fasta_path: str, k: int, skip: int, n_shards: int,
                   halo: int, max_freq: int, dual: bool = False,
                   canonical: bool = False) -> str:
        # every parameter that changes the shard CSR bytes must key the
        # artifact: max_freq bakes repeat masking into the tables, so a
        # stale cache would silently map with the wrong masking; canonical
        # changes the entry encoding ((pos<<1)|flip vs raw positions)
        bs = "-bs" if dual else ""
        cn = "-c" if canonical else ""
        return (f"{fasta_path}.ngmt-shards-{k}-{skip}-s{n_shards}-h{halo}"
                f"-f{max_freq}{bs}{cn}.v{ShardedIndex.SHARDS_VERSION}.npz")

    def save(self, path: str, genome_sha1: str) -> None:
        # 5th meta field (canonical) is appended so pre-existing 4-field
        # artifacts stay loadable (absent => non-canonical)
        meta = (
            f"{self.n_shards}|{self.max_freq}|{int(self.dual)}|{genome_sha1}"
            f"|{int(self.canonical)}"
        )
        np.savez(
            path, genome=self.genome, offsets=self.offsets,
            positions=self.positions, base=self.base,
            core_lo=self.core_lo, core_hi=self.core_hi,
            meta=np.frombuffer(meta.encode(), dtype=np.uint8),
        )

    @classmethod
    def load(cls, path: str, genome_sha1: str,
             max_freq: int | None = None) -> "ShardedIndex | None":
        with np.load(path) as z:
            meta = bytes(z["meta"]).decode().split("|")
            if len(meta) not in (4, 5):  # unknown layout: treat as stale
                return None
            n_shards, mf, dual, sha = meta[:4]
            canon = bool(int(meta[4])) if len(meta) == 5 else False
            if sha != genome_sha1:
                return None
            if max_freq is not None and int(mf) != max_freq:
                return None
            return cls(
                n_shards=int(n_shards), genome=z["genome"],
                offsets=z["offsets"], positions=z["positions"],
                base=z["base"], core_lo=z["core_lo"], core_hi=z["core_hi"],
                max_freq=int(mf), dual=bool(int(dual)), canonical=canon,
            )

    # -- per-shard artifacts (cross-host: a host memoizes/loads ONLY its own
    # shard, so steady-state host+device memory is 1/S of the index) --

    @staticmethod
    def shard_cache_path(fasta_path: str, s: int, k: int, skip: int,
                         n_shards: int, halo: int, max_freq: int,
                         dual: bool = False, canonical: bool = False) -> str:
        bs = "-bs" if dual else ""
        cn = "-c" if canonical else ""
        return (f"{fasta_path}.ngmt-shard{s}of{n_shards}-{k}-{skip}-h{halo}"
                f"-f{max_freq}{bs}{cn}.v{ShardedIndex.SHARDS_VERSION}.npz")

    def save_shards(self, path_for, genome_sha1: str) -> None:
        """Write one artifact per OWNED shard row (path_for(s) -> path).
        Each file is self-sufficient: it carries the full [S] range metadata
        and the global padded widths, so a later process can load just its
        own shards and still build mesh-compatible global arrays."""
        own = (range(self.n_shards) if self.shard_ids is None
               else self.shard_ids)
        for i, s in enumerate(own):
            meta = (f"{self.n_shards}|{self.max_freq}|{int(self.dual)}|"
                    f"{genome_sha1}|{int(self.canonical)}")
            np.savez(
                path_for(int(s)),
                genome=self.genome[i], offsets=self.offsets[i],
                positions=self.positions[i], base=self.base,
                core_lo=self.core_lo, core_hi=self.core_hi,
                shard=np.int64(s),
                meta=np.frombuffer(meta.encode(), dtype=np.uint8),
            )

    @classmethod
    def load_shards(cls, paths: list[str], shard_ids, genome_sha1: str,
                    max_freq: int | None = None) -> "ShardedIndex | None":
        """Load a subset of shards from per-shard artifacts (all-or-nothing)."""
        rows = []
        import os

        for p in paths:
            if not os.path.exists(p):
                return None
            with np.load(p) as z:
                meta = bytes(z["meta"]).decode().split("|")
                if len(meta) not in (4, 5) or meta[3] != genome_sha1:
                    return None
                if max_freq is not None and int(meta[1]) != max_freq:
                    return None
                rows.append({k: z[k] for k in z.files if k != "meta"}
                            | {"n_shards": int(meta[0]),
                               "max_freq": int(meta[1]),
                               "dual": bool(int(meta[2])),
                               "canonical": (bool(int(meta[4]))
                                             if len(meta) == 5 else False)})
        r0 = rows[0]
        return cls(
            n_shards=r0["n_shards"],
            genome=np.stack([r["genome"] for r in rows]),
            offsets=np.stack([r["offsets"] for r in rows]),
            positions=np.stack([r["positions"] for r in rows]),
            base=r0["base"], core_lo=r0["core_lo"], core_hi=r0["core_hi"],
            max_freq=r0["max_freq"], dual=r0["dual"],
            canonical=r0["canonical"],
            shard_ids=np.asarray(list(shard_ids), np.int32),
        )


def open_sharded(cfg: NgmConfig, ref_path: str, genome, index) -> ShardedIndex:
    """Build-or-load the memoized per-shard artifact (.ngmt-shards).

    `index` is a host KmerIndex (non-canonical) or a (CT, GA) pair for
    bisulfite.  Shared by the `ngm-tpu index --index-shards N` verb (pre-pay
    the minutes-long gigabase shard split) and run_mapping (zero index work
    when the artifact exists).
    """
    import os

    from nextgenmap_tpu.utils.logging import get_logger

    log = get_logger("ngm-tpu.index")
    dual = isinstance(index, tuple)
    canonical = (not dual) and getattr(index, "canonical", False)
    halo = ShardedIndex.halo_for(cfg)
    cache = ShardedIndex.cache_path(
        ref_path, cfg.kmer, cfg.kmer_skip, cfg.index_shards, halo,
        cfg.max_kmer_freq, dual=dual, canonical=canonical,
    )
    if os.path.exists(cache):
        sidx = ShardedIndex.load(cache, genome.sha1(),
                                 max_freq=cfg.max_kmer_freq)
        if sidx is not None:
            log.info("loaded sharded index from %s", cache)
            return sidx
    if dual:
        sidx = ShardedIndex.build_dual(
            *index, genome.codes, cfg.index_shards, halo
        )
    else:
        sidx = ShardedIndex.build(index, genome.codes, cfg.index_shards, halo)
    if not cfg.skip_save:
        try:
            sidx.save(cache, genome.sha1())
            log.info("memoized sharded index to %s", cache)
        except OSError as e:
            log.warning("could not memoize sharded index: %s", e)
    return sidx


def global_ish_mesh(n_shards: int) -> Mesh:
    """("dp", "ish") mesh over ALL global devices with ish == n_shards.

    The ish axis is PROCESS-MAJOR: shard columns are grouped by host
    (jax.devices() orders devices by process), so a host's devices cover only
    its own n_shards/n_processes shard columns and the host holds ONLY those
    shards — the pod-scale layout of the north star ("index sharded across
    hosts").  Within a host, remaining local devices form the dp rows (reads
    data-parallel), and the merged output is replicated across ish, so every
    process can address the full result."""
    import jax

    devs = np.array(jax.devices())
    nproc = jax.process_count()
    if n_shards % nproc:
        raise ValueError(
            f"index_shards={n_shards} must be a multiple of the process "
            f"count {nproc} (each host holds the same number of shards)"
        )
    sph = n_shards // nproc                  # shards per host
    if devs.shape[0] % nproc:
        raise ValueError("uneven device counts across processes")
    L = devs.shape[0] // nproc               # local devices per process
    if L % sph:
        raise ValueError(
            f"local device count {L} not divisible by shards-per-host {sph}"
        )
    dp = L // sph
    grid = devs.reshape(nproc, sph, dp).transpose(2, 0, 1).reshape(dp, n_shards)
    return Mesh(grid, ("dp", "ish"))


def local_shard_ids(mesh: Mesh) -> list[int]:
    """Global shard ids whose column contains a process-local device."""
    import jax

    local = set(jax.local_devices())
    grid = np.asarray(mesh.devices)
    return sorted({
        s for d in range(grid.shape[0]) for s in range(grid.shape[1])
        if grid[d, s] in local
    })


def open_sharded_local(cfg: NgmConfig, ref_path: str, genome,
                       shard_ids) -> ShardedIndex:
    """Build-or-load ONLY this host's shards (cross-host index sharding).

    Fast path: per-shard artifacts exist (ngm-tpu index --index-shards N
    pre-builds all of them) -> load just shard_ids; the host never touches
    the global CSR.  Slow path: build the global host index (memoized), slice
    this host's shards, and memoize them as per-shard artifacts."""
    from nextgenmap_tpu.utils.logging import get_logger

    log = get_logger("ngm-tpu.index")
    dual = cfg.bs_mapping
    halo = ShardedIndex.halo_for(cfg)
    S = cfg.index_shards
    # canonical needs global (pos << 1) | flip to fit uint32 during the
    # host build; past 2^31 bases the build falls back to raw positions
    canonical = (not dual) and genome.codes.shape[0] < 2**31
    path_for = lambda s: ShardedIndex.shard_cache_path(
        ref_path, s, cfg.kmer, cfg.kmer_skip, S, halo, cfg.max_kmer_freq,
        dual=dual, canonical=canonical,
    )
    sidx = ShardedIndex.load_shards(
        [path_for(s) for s in shard_ids], shard_ids, genome.sha1(),
        max_freq=cfg.max_kmer_freq,
    )
    if sidx is not None:
        log.info("loaded own index shards %s from per-shard artifacts",
                 list(shard_ids))
        return sidx
    if dual:
        pair = tuple(
            KmerIndex.open(
                ref_path, genome.codes, genome.sha1(), k=cfg.kmer,
                skip=cfg.kmer_skip, max_freq=cfg.max_kmer_freq, collapse=c,
                skip_save=cfg.skip_save,
            )
            for c in ("ct", "ga")
        )
        sidx = ShardedIndex.build_dual(*pair, genome.codes, S, halo,
                                       shard_ids=shard_ids)
    else:
        idx = KmerIndex.open(
            ref_path, genome.codes, genome.sha1(), k=cfg.kmer,
            skip=cfg.kmer_skip, max_freq=cfg.max_kmer_freq,
            skip_save=cfg.skip_save, canonical=True, allow_u32=True,
        )
        sidx = ShardedIndex.build(idx, genome.codes, S, halo,
                                  shard_ids=shard_ids)
    if not cfg.skip_save:
        try:
            sidx.save_shards(path_for, genome.sha1())
            log.info("memoized own index shards %s", list(shard_ids))
        except OSError as e:
            log.warning("could not memoize index shards: %s", e)
    return sidx


def make_global_ish_arrays(mesh: Mesh, sidx: ShardedIndex):
    """Assemble the global (genome, offsets, positions, base, core_lo,
    core_hi) arrays for make_index_sharded_map_step from a host-local shard
    subset, via jax.make_array_from_single_device_arrays: each global device
    receives exactly its own shard's row from the process that owns it.

    Logs the per-host device bytes — the memory-accounting proof that a host
    holds 1/S of the index, not all of it."""
    import jax
    from jax.sharding import NamedSharding

    from nextgenmap_tpu.utils.logging import get_logger

    log = get_logger("ngm-tpu.index")
    S = sidx.n_shards
    own = (list(range(S)) if sidx.shard_ids is None
           else [int(s) for s in sidx.shard_ids])
    grid = np.asarray(mesh.devices)          # [dp, S]
    local = set(jax.local_devices())

    def make(field: np.ndarray, row_of):
        gshape = (S,) + field.shape[1:]
        sh = NamedSharding(mesh, P("ish"))
        pieces = []
        for d in range(grid.shape[0]):
            for s in range(grid.shape[1]):
                dev = grid[d, s]
                if dev in local:
                    pieces.append(jax.device_put(row_of(field, s), dev))
        return jax.make_array_from_single_device_arrays(gshape, sh, pieces)

    def own_row(field, s):
        return field[own.index(s)][None]

    def meta_row(field, s):                   # base/core_lo/core_hi: full [S]
        return field[s][None]

    args = (
        make(sidx.genome, own_row),
        make(sidx.offsets, own_row),
        make(sidx.positions, own_row),
        make(sidx.base, meta_row),
        make(sidx.core_lo, meta_row),
        make(sidx.core_hi, meta_row),
    )
    local_bytes = (
        sidx.genome.nbytes + sidx.offsets.nbytes + sidx.positions.nbytes
    )
    full_bytes = local_bytes * S // max(1, len(own))
    log.info(
        "cross-host index shards: this host holds shards %s = %.1f MB of "
        "%.1f MB total (%d/%d shards)",
        own, local_bytes / 1e6, full_bytes / 1e6, len(own), S,
    )
    return args


def _lex_winner(sc, st, gp):
    """Lexicographic argmax over the leading shard axis:
    (score DESC, strand fwd first, global position ASC, shard ASC)."""
    best_sc = jnp.max(sc, axis=0)
    cand = sc == best_sc
    st_m = jnp.where(cand, st, 2)
    cand &= st_m == jnp.min(st_m, axis=0)
    gp_m = jnp.where(cand, gp, UPOS_MAX)
    cand &= gp_m == jnp.min(gp_m, axis=0)
    return jnp.argmax(cand, axis=0), best_sc  # argmax = first true = lowest shard


def _take_shard(field_all, winner):
    """field_all [S, B, ...] -> [B, ...] selecting winner[b] per read."""
    extra = field_all.ndim - 2
    idx = winner.reshape(winner.shape + (1,) * extra)[None]
    return jnp.take_along_axis(field_all, idx, axis=0)[0]


@partial(jax.jit, static_argnames=("paired", "read_len"))
def merge_sharded_results(
    stk: MapResult, base, core_lo, core_hi, *, paired: bool, read_len: int
) -> MapResult:
    """Merge per-shard MapResults (leading S axis) into the global result.

    The SINGLE definition of the cross-shard merge semantics — the mesh path
    feeds it all_gathered [S, B] fields, the sequential one-chip loop feeds
    it host-stacked fields, so the two products are identical by
    construction.  Ownership is by RAW score + core range (not the
    post-filter `mapped` flag): the single-device semantics pick the SW
    argmax first and apply identity/residue filters to the winner only, and
    the MAPQ second-best counts unfiltered candidates.  Merge key: score
    DESC, strand fwd first, global position ASC, shard ASC.
    """
    L = read_len
    S, B = stk.score.shape
    base = base.astype(jnp.uint32)[:, None]
    has_aln = stk.score > 0
    gpos = jnp.where(has_aln, base + stk.pos.astype(jnp.uint32), UPOS_MAX)
    own = (
        has_aln
        & (gpos >= core_lo.astype(jnp.uint32)[:, None])
        & (gpos < core_hi.astype(jnp.uint32)[:, None])
    )
    sc_all = jnp.where(own, stk.score, -1)
    st_all = jnp.where(own, stk.strand, 2)
    gp_all = jnp.where(own, gpos, UPOS_MAX)
    winner, _ = _lex_winner(sc_all, st_all, gp_all)

    if paired:
        # pair-consistent merge: a proper pair is owned via MATE1's
        # position; if any shard resolved the pair properly, both mates
        # come from the (proper DESC, combined DESC, pos1 ASC, shard ASC)
        # winner; otherwise mates merge independently (broken pair).
        Pn = B // 2
        s_pair = sc_all.reshape(S, Pn, 2)
        prop = stk.proper.reshape(S, Pn, 2)
        proper_p = prop[:, :, 0] & prop[:, :, 1]
        own1 = own.reshape(S, Pn, 2)[:, :, 0]
        pair_ok = proper_p & own1
        comb_all = jnp.where(pair_ok, s_pair[:, :, 0] + s_pair[:, :, 1], -1)
        gp1_all = jnp.where(pair_ok, gpos.reshape(S, Pn, 2)[:, :, 0], UPOS_MAX)
        best_comb = jnp.max(comb_all, axis=0)
        candp = comb_all == best_comb
        gp1_m = jnp.where(candp, gp1_all, UPOS_MAX)
        candp &= gp1_m == jnp.min(gp1_m, axis=0)
        winner_pair = jnp.argmax(candp, axis=0)
        any_proper = best_comb > 0
        winner = jnp.where(
            jnp.repeat(any_proper, 2),
            jnp.repeat(winner_pair, 2),
            winner,
        )

    # global second-best for MAPQ: other shards' best at a different
    # locus, or the winner shard's own local second
    win_gp = _take_shard(gp_all, winner)
    win_sc = _take_shard(sc_all, winner)
    if paired:
        # a proper pair comes whole from the shard owning mate 1, so mate 2
        # may lie past that shard's core, in its halo: take its score and
        # position from that shard whether or not the shard owns it
        pair_win = jnp.repeat(any_proper, 2)
        raw_sc = jnp.where(has_aln, stk.score, -1)
        win_gp = jnp.where(pair_win, _take_shard(gpos, winner), win_gp)
        win_sc = jnp.where(pair_win, _take_shard(raw_sc, winner), win_sc)
    # unsigned distance (uint32 subtraction wraps; use max-min)
    far = (
        jnp.maximum(gp_all, win_gp[None]) - jnp.minimum(gp_all, win_gp[None])
    ) > jnp.uint32(L)
    s2_other = jnp.max(jnp.where(far, sc_all, 0), axis=0)
    s2_local = _take_shard(stk.second, winner)
    s2 = jnp.maximum(s2_other, s2_local)

    merged = {}
    for name in MapResult._fields:
        val = getattr(stk, name)
        if name in ("fanout_overflow", "cmr_overflow"):
            merged[name] = jnp.sum(val, axis=0)  # the "ish" psum equivalent
            continue
        if name == "pos":
            val = gpos  # uint32 global coordinates
        merged[name] = _take_shard(val, winner)

    mapped = merged["mapped"] & (win_sc > 0)
    s1f = jnp.maximum(1, win_sc).astype(jnp.float32)
    mapq = jnp.clip(
        jnp.round(60.0 * (win_sc - s2).astype(jnp.float32) / s1f), 0, 60
    ).astype(jnp.int32)
    merged["mapped"] = mapped
    merged["second"] = s2
    merged["mapq"] = jnp.where(mapped, mapq, 0)
    merged["proper"] = merged["proper"] & mapped
    return MapResult(**merged)


@partial(jax.jit, static_argnames=("topn", "read_len"))
def merge_sharded_topn(
    stk: MapResult, base, core_lo, core_hi, *, topn: int, read_len: int
) -> tuple:
    """Merge per-shard topn MapResults (fields [S, R, B]) into global rank
    lists (ref -n with --index-shards).

    Exactness argument: every candidate a shard owns that belongs in the
    GLOBAL top R is necessarily in that shard's LOCAL top R (per-shard lists
    are sorted by the same rule-11 keys), so interleaving the S*R owned
    entries by (score DESC, strand fwd first, global position ASC, shard
    ASC) and taking the first R reproduces the unsharded ranking.  MAPQ
    second-best mirrors merge_sharded_results: other owned entries at a far
    locus, or the winning entry's own local second.
    """
    L = read_len
    S, R, B = stk.score.shape
    base_u = base.astype(jnp.uint32)[:, None, None]
    lo_u = core_lo.astype(jnp.uint32)[:, None, None]
    hi_u = core_hi.astype(jnp.uint32)[:, None, None]
    has = stk.score > 0
    gpos = jnp.where(has, base_u + stk.pos.astype(jnp.uint32), UPOS_MAX)
    own = has & (gpos >= lo_u) & (gpos < hi_u)
    E = S * R

    as_be = lambda x: jnp.transpose(x.reshape(E, B))             # [B, E]
    sc_e = as_be(jnp.where(own, stk.score, -1))
    st_e = as_be(jnp.where(own, stk.strand, 2))
    gp_e = as_be(jnp.where(own, gpos, UPOS_MAX))
    eidx = jnp.broadcast_to(
        jax.lax.broadcasted_iota(jnp.int32, (1, E), 1), (B, E)
    )
    # stable lexicographic sort; equal keys resolve by entry index =
    # (shard ASC, rank ASC), the rule-11 shard tie-break
    _, _, _, order = jax.lax.sort(
        (-sc_e, st_e, gp_e, eidx), num_keys=3
    )
    sel = order[:, :R]                                           # [B, R]
    brow = jnp.arange(B)[:, None]

    def take(x):                     # [S, R, B, ...] -> [B, R, ...]
        x_e = x.reshape((E, B) + x.shape[3:])
        return x_e[sel, brow]

    win_sc = take(jnp.where(own, stk.score, 0))
    win_gp = take(gpos)
    # far second-best per rank: other owned entries at a different locus
    far = (
        jnp.maximum(gp_e[:, None, :], win_gp[:, :, None])
        - jnp.minimum(gp_e[:, None, :], win_gp[:, :, None])
    ) > jnp.uint32(L)                                            # [B, R, E]
    s2_other = jnp.max(
        jnp.where(far & (sc_e[:, None, :] > 0), sc_e[:, None, :], 0), axis=2
    )
    s2 = jnp.maximum(s2_other, take(stk.second))                 # [B, R]

    fan_ovf = jnp.sum(stk.fanout_overflow[:, 0])
    cmr_ovf = jnp.sum(stk.cmr_overflow[:, 0])
    results = []
    for j in range(R):
        fields = {}
        for name in MapResult._fields:
            if name in ("fanout_overflow", "cmr_overflow"):
                continue
            val = gpos if name == "pos" else getattr(stk, name)
            fields[name] = take(val)[:, j]
        mapped = fields["mapped"] & (win_sc[:, j] > 0)
        s1f = jnp.maximum(1, win_sc[:, j]).astype(jnp.float32)
        mapq = jnp.clip(
            jnp.round(
                60.0 * (win_sc[:, j] - s2[:, j]).astype(jnp.float32) / s1f
            ), 0, 60,
        ).astype(jnp.int32)
        fields["mapped"] = mapped
        fields["second"] = s2[:, j]
        fields["mapq"] = jnp.where(mapped, mapq, 0)
        results.append(MapResult(
            fanout_overflow=fan_ovf, cmr_overflow=cmr_ovf, **fields
        ))
    return tuple(results)


def make_index_sharded_map_step(mesh: Mesh, paired: bool, read_len: int, **statics):
    """Mapping step over a ("dp", "ish") mesh: reads data-parallel over dp,
    index position-sharded over ish, per-read (or per-pair) merge over ish."""
    base_fn = map_step_paired if paired else map_step
    fn = partial(base_fn, cs_axis="ish", **statics)

    def inner(genome_s, off_s, pos_s, base_s, core_lo_s, core_hi_s, *args):
        res = fn(genome_s[0], off_s[0], pos_s[0], *args)
        ag = lambda x: jax.lax.all_gather(x, "ish")
        stk = MapResult(*[ag(getattr(res, f)) for f in MapResult._fields])
        merged = merge_sharded_results(
            stk, ag(base_s[0]), ag(core_lo_s[0]), ag(core_hi_s[0]),
            paired=paired, read_len=read_len,
        )
        # dp-axis reduction of the audit counters
        return merged._replace(
            fanout_overflow=jax.lax.psum(merged.fanout_overflow, "dp"),
            cmr_overflow=jax.lax.psum(merged.cmr_overflow, "dp"),
        )

    n_scalar = 10 if paired else 7
    in_specs = (
        P("ish"), P("ish"), P("ish"), P("ish"), P("ish"), P("ish"),
        P("dp"), P("dp"),   # reads, lengths
        P(),                # matrices
    ) + (P(),) * n_scalar
    out_specs = MapResult(
        **{
            name: P() if name.endswith("overflow") else P("dp")
            for name in MapResult._fields
        }
    )
    return jax.jit(
        jax.shard_map(
            inner, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
    )
