"""Pipeline orchestration: stream reads -> jitted device step -> SAM out.

Reference analog: the _NGM singleton's init + thread main loop
(ref:src/NGM.cpp, SURVEY.md §3.1/§3.2).  The pthread pipeline becomes:
host streaming (io/fastq.py) feeding one bulk-synchronous jitted step per
batch (models/mapper.py), with SAM emission on the host in input order.
"""

from __future__ import annotations

import os
import time

import numpy as np

from nextgenmap_tpu.config import NgmConfig
from nextgenmap_tpu.index.genome import Genome
from nextgenmap_tpu.index.kmer_index import KmerIndex
from nextgenmap_tpu.io.encode import revcomp_codes
from nextgenmap_tpu.io.fastq import ReadBatch, batch_paired, batch_single, peek_read_len
from nextgenmap_tpu.io.sam import SamWriter, open_output
from nextgenmap_tpu.models.mapper import Mapper, MapResult
from nextgenmap_tpu.utils.logging import get_logger
from nextgenmap_tpu.utils.stats import MappingStats

log = get_logger("ngm-tpu.run")

# host-build cutoff for devices that report no memory limit (the CPU backend)
_HOST_BUILD_BASES = 1 << 28
# the device build's positions and offsets are int32
_DEVICE_BUILD_MAX_BASES = 1 << 31


def device_build_fits(n_bases: int) -> bool:
    """Whether the on-device index build fits: its int32 positions must hold
    every coordinate, and its sort needs ~25x the genome in device memory
    (memory_stats()["bytes_limit"])."""
    import jax

    if n_bases >= _DEVICE_BUILD_MAX_BASES:
        return False
    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if limit is None:
        return n_bases <= _HOST_BUILD_BASES
    return 25 * n_bases <= limit


def load_reference(cfg: NgmConfig, ref_path: str):
    """Returns (genome, index) where index is None (device build), one
    KmerIndex, or a (CT, GA) pair for bisulfite mode."""
    genome = Genome.open(ref_path, skip_save=cfg.skip_save)
    # the k-mer index builds on DEVICE in seconds (index/device_build.py),
    # so unlike the reference there is nothing to memoize on the hot path; a
    # host-built artifact (ngm-tpu index verb / KmerIndex.open) is still
    # honored when present
    import os

    def try_load(collapse: str) -> KmerIndex | None:
        cache = KmerIndex.cache_path(
            ref_path, cfg.kmer, cfg.kmer_skip, collapse,
            canonical=(collapse == "none"),
        )
        if os.path.exists(cache):
            index = KmerIndex.load(cache)
            if index.genome_sha1 == genome.sha1():
                log.info("loaded k-mer index from %s", cache)
                return index
        return None

    if cfg.shard_hosts:
        # cross-host index sharding: this host builds/loads ONLY its own
        # shard(s) — resolved in run_mapping once the global mesh exists
        # (parallel/index_shard.py::open_sharded_local)
        return genome, None
    if cfg.bs_mapping:
        if cfg.index_shards > 1:
            # sharding slices host CSRs by position range, so both collapsed
            # tables must exist as host indexes (built + memoized here)
            pair = tuple(
                KmerIndex.open(
                    ref_path, genome.codes, genome.sha1(),
                    k=cfg.kmer, skip=cfg.kmer_skip,
                    max_freq=cfg.max_kmer_freq, collapse=c,
                    skip_save=cfg.skip_save,
                )
                for c in ("ct", "ga")
            )
            return genome, pair
        ct, ga = try_load("ct"), try_load("ga")
        return genome, (ct, ga) if ct and ga else None
    if cfg.index_shards > 1:
        # position-range sharding slices the host CSR by range; CANONICAL
        # entries ((pos<<1)|flip, monotone in pos) slice just as well with
        # doubled bounds, and the per-shard rebase brings them back into
        # int32 — so shards get the one-lookup-serves-both-strands CS win
        # (the round-1 canonical lever) even at gigabase scale.  Past 2^31
        # bases the global entries no longer fit uint32; build falls back
        # to raw positions (allow_u32 handles the [2^30, 2^31) window).
        idx = KmerIndex.open(
            ref_path, genome.codes, genome.sha1(),
            k=cfg.kmer, skip=cfg.kmer_skip, max_freq=cfg.max_kmer_freq,
            skip_save=cfg.skip_save, canonical=True, allow_u32=True,
        )
        return genome, idx
    idx = try_load("none")
    # past what the device build's sort fits, build on the host instead
    # (memoized, like the reference's .ngm files)
    if idx is None and not device_build_fits(genome.codes.shape[0]):
        log.info("large genome: building k-mer index on host (one-time)")
        idx = KmerIndex.open(
            ref_path, genome.codes, genome.sha1(),
            k=cfg.kmer, skip=cfg.kmer_skip, max_freq=cfg.max_kmer_freq,
            skip_save=cfg.skip_save,
            canonical=genome.codes.shape[0] < 2**30,
        )
    return genome, idx


def aligned_rows(codes: np.ndarray, lens: np.ndarray, read_len: int,
                 strand: np.ndarray) -> np.ndarray:
    """[n, L] codes in ALIGNED orientation (rc'd where strand==1).

    Short reverse reads are left-shifted after the flip so each row starts at
    column 0 (rc of a right-padded row is left-padded).
    """
    rc = np.where(codes < 4, 3 - codes.astype(np.int16), codes)[:, ::-1]
    aligned = np.where((strand == 1)[:, None], rc, codes).astype(np.uint8)
    short = np.nonzero((lens < read_len) & (strand == 1))[0]
    if short.size:
        # one vectorized take over the short subset (a per-row Python loop
        # here would sit on the emitter path of mixed-length batches)
        sub = aligned[short]
        Ls = lens[short][:, None]
        j = np.arange(read_len)[None, :]
        src = np.minimum(j + (read_len - Ls), read_len - 1)
        shifted = np.take_along_axis(sub, src, axis=1)
        shifted[j >= Ls] = 4
        aligned[short] = shifted
    return aligned


def aligned_codes_batch(batch: ReadBatch, strand: np.ndarray, n: int) -> np.ndarray:
    return aligned_rows(batch.codes[:n], batch.lengths[:n], batch.read_len, strand)


def clip_mode_of(cfg: NgmConfig) -> int:
    return 1 if cfg.hard_clip else (2 if cfg.silent_clip else 0)


def _emit_single_native(writer: SamWriter, batch: ReadBatch, res: MapResult,
                        stats: MappingStats) -> None:
    """Native-formatter batch emission (nextgenmap_tpu/native/ngmio.cpp,
    reference analog SAMWriter.cpp): ONE C call formats the whole batch —
    mapped and unmapped rows alike — in input order."""
    from nextgenmap_tpu import native

    t0 = time.perf_counter()
    n = batch.n
    mapped = np.asarray(res.mapped)[:n].astype(bool)
    strand = np.where(mapped, np.asarray(res.strand)[:n], 0)
    pos = np.where(mapped, np.asarray(res.pos)[:n].astype(np.int64), 0)
    ops_h = np.asarray(res.ops)[:n]
    stats.kmer_fanout_overflow += int(res.fanout_overflow)
    stats.cmr_overflow += int(res.cmr_overflow)
    stats.reads_in += n
    n_mapped = int(mapped.sum())
    stats.reads_mapped += n_mapped
    stats.reads_unmapped += n - n_mapped
    t1 = time.perf_counter()
    stats.add_time("fetch", t1 - t0)

    genome = writer.genome
    aligned = aligned_codes_batch(batch, strand, n)
    ci = np.zeros(n, np.int64)
    cp = np.full(n, -1, np.int64)
    midx = np.nonzero(mapped)[0]
    if midx.size:
        mci, mcp = genome.abs_to_chrom(pos[midx])
        ci[midx] = np.atleast_1d(mci)
        cp[midx] = np.atleast_1d(mcp)
    names_arr = np.asarray(genome.names + ["*"], dtype=object)
    rnames = names_arr[np.where(mapped, ci, len(genome.names))].tolist()
    n_ops = np.where(mapped, np.asarray(res.n_ops)[:n], 0)
    matches = np.asarray(res.matches)[:n]
    ident = matches.astype(np.float32) / np.maximum(1, n_ops)
    if writer.cfg.no_unal and n_mapped < n:
        keep = midx
        sel = lambda a: a[keep]
        sel_l = lambda xs: [xs[i] for i in keep]
        n_out = midx.size
    else:
        sel = lambda a: a
        sel_l = lambda xs: xs[:n]
        n_out = n
    if n_out == 0:
        return
    blob = native.format_sam(
        names=sel_l(batch.names),
        aligned_codes=sel(aligned),
        read_len=sel(batch.lengths[:n]),
        quals=sel_l(batch.quals),
        qual_rev=sel(strand.astype(np.uint8)),
        flag=sel((strand * 16 + (~mapped) * 4).astype(np.int32)),
        chrom_pos=sel(cp),
        rnames=sel_l(rnames),
        mapq=sel(np.where(mapped, np.asarray(res.mapq)[:n], 0)),
        score=sel(np.asarray(res.score)[:n]),
        ops=sel(ops_h),
        n_ops=sel(n_ops),
        q_start=sel(np.asarray(res.q_start)[:n]),
        q_end=sel(np.asarray(res.q_end)[:n]),
        genome_codes=genome.codes,
        gpos_abs=sel(pos),
        rnexts=["*"] * n_out,
        pnext=np.zeros(n_out, np.int64),
        tlen=np.zeros(n_out, np.int64),
        identity=sel(ident),
        rg_suffix=writer._tags_suffix(),
        clip_mode=clip_mode_of(writer.cfg),
        is_mapped=sel(mapped.astype(np.uint8)),
    )
    t2 = time.perf_counter()
    stats.add_time("format", t2 - t1)
    writer.out.write(blob.decode("ascii"))
    stats.add_time("write", time.perf_counter() - t2)


def emit_single(writer: SamWriter, batch: ReadBatch, res: MapResult,
                stats: MappingStats) -> None:
    """Write one single-end batch's records in input order."""
    from nextgenmap_tpu import native

    if native.lib() is not None:
        return _emit_single_native(writer, batch, res, stats)
    mapped = np.asarray(res.mapped)
    strand = np.asarray(res.strand)
    pos = np.asarray(res.pos)
    mapq = np.asarray(res.mapq)
    score = np.asarray(res.score)
    ops = np.asarray(res.ops)
    n_ops = np.asarray(res.n_ops)
    q_start = np.asarray(res.q_start)
    q_end = np.asarray(res.q_end)
    matches = np.asarray(res.matches)
    stats.kmer_fanout_overflow += int(res.fanout_overflow)
    stats.cmr_overflow += int(res.cmr_overflow)
    for i in range(batch.n):
        stats.reads_in += 1
        L = int(batch.lengths[i])
        if not mapped[i]:
            stats.reads_unmapped += 1
            writer.write_unmapped(batch.names[i], batch.codes[i, :L], batch.quals[i])
            continue
        stats.reads_mapped += 1
        st = int(strand[i])
        codes = batch.codes[i, :L]
        aligned = revcomp_codes(codes) if st else codes
        no = int(n_ops[i])
        ident = float(matches[i]) / max(1, no)
        writer.write_mapped(
            batch.names[i], aligned, batch.quals[i], L, st,
            int(pos[i]), int(mapq[i]), int(score[i]),
            ops[i], no, int(q_start[i]), int(q_end[i]), ident,
        )


def _emit_single_topn_native(writer: SamWriter, batch: ReadBatch,
                             results: tuple, stats: MappingStats,
                             strata: bool, read_len: int) -> None:
    """Vectorized topn emission: selection masks in numpy, rendering in ONE
    native call (rows ordered read-major, rank ascending — same order as the
    Python loop)."""
    from nextgenmap_tpu import native
    from nextgenmap_tpu.io.sam import FLAG_SECONDARY, FLAG_UNMAPPED

    n = batch.n
    J = len(results)
    F = lambda f: np.stack([np.asarray(getattr(r, f))[:n] for r in results])
    mapped = F("mapped").astype(bool)     # [J, n]
    score = F("score")
    pos = F("pos").astype(np.int64)
    strand = F("strand")
    mapq = F("mapq")
    n_ops = F("n_ops")
    stats.kmer_fanout_overflow += int(results[0].fanout_overflow)
    stats.cmr_overflow += int(results[0].cmr_overflow)
    stats.reads_in += n
    n_mapped0 = int(mapped[0].sum())
    stats.reads_mapped += n_mapped0
    stats.reads_unmapped += n - n_mapped0

    # eligibility chain per the sequential semantics: rank j emits iff every
    # rank < j kept the chain alive (mapped, score > 0, in-stratum) and j
    # isn't a near-duplicate (within read_len) of an emitted better hit
    best = score[0]
    emit = np.zeros((J, n), bool)
    chain = mapped[0].copy()
    for j in range(J):
        chain = chain & mapped[j] & (score[j] > 0)
        if strata and j > 0:
            chain = chain & (score[j] >= best)
        dup = np.zeros(n, bool)
        for k in range(j):
            dup |= emit[k] & (np.abs(pos[j] - pos[k]) <= read_len)
        emit[j] = chain & ~dup  # duplicates skip this rank but don't break
    # row matrix [n, J]: column 0 may also carry the unmapped record
    M = emit.T.copy()
    unmapped_row = ~mapped[0]
    if not writer.cfg.no_unal:
        M[unmapped_row, 0] = True
    ii, jj = np.nonzero(M)                # read-major, rank-ascending order
    if ii.size == 0:
        return
    row_mapped = mapped[0][ii] & emit[jj, ii]
    r_strand = np.where(row_mapped, strand[jj, ii], 0)
    r_pos = np.where(row_mapped, pos[jj, ii], 0)
    genome = writer.genome
    ci = np.zeros(ii.size, np.int64)
    cp = np.full(ii.size, -1, np.int64)
    ridx = np.nonzero(row_mapped)[0]
    if ridx.size:
        mci, mcp = genome.abs_to_chrom(r_pos[ridx])
        ci[ridx] = np.atleast_1d(mci)
        cp[ridx] = np.atleast_1d(mcp)
    names_arr = np.asarray(genome.names + ["*"], dtype=object)
    rnames = names_arr[np.where(row_mapped, ci, len(genome.names))].tolist()
    lens = batch.lengths[:n][ii]
    aligned = aligned_rows(batch.codes[:n][ii], lens, batch.read_len, r_strand)
    r_nops = np.where(row_mapped, n_ops[jj, ii], 0)
    ident = F("matches")[jj, ii].astype(np.float32) / np.maximum(1, r_nops)
    flag = (
        r_strand * 16
        + np.where(row_mapped, np.where(jj > 0, FLAG_SECONDARY, 0),
                   FLAG_UNMAPPED)
    ).astype(np.int32)
    blob = native.format_sam(
        names=[batch.names[i] for i in ii],
        aligned_codes=aligned,
        read_len=lens,
        quals=[batch.quals[i] for i in ii],
        qual_rev=r_strand.astype(np.uint8),
        flag=flag,
        chrom_pos=cp,
        rnames=rnames,
        mapq=np.where(row_mapped & (jj == 0), mapq[0][ii], 0),
        score=score[jj, ii],
        ops=F("ops")[jj, ii],
        n_ops=r_nops,
        q_start=F("q_start")[jj, ii],
        q_end=F("q_end")[jj, ii],
        genome_codes=genome.codes,
        gpos_abs=r_pos,
        rnexts=["*"] * ii.size,
        pnext=np.zeros(ii.size, np.int64),
        tlen=np.zeros(ii.size, np.int64),
        identity=ident,
        rg_suffix=writer._tags_suffix(),
        clip_mode=clip_mode_of(writer.cfg),
        is_mapped=row_mapped.astype(np.uint8),
    )
    writer.out.write(blob.decode("ascii"))


def emit_single_topn(writer: SamWriter, batch: ReadBatch, results: tuple,
                     stats: MappingStats, strata: bool, read_len: int) -> None:
    """Emit up to topn alignments per read; entries past the first are SAM
    secondaries (FLAG 0x100).  --strata keeps only the top-score stratum;
    near-duplicates (within a read length of a better hit) are suppressed."""
    from nextgenmap_tpu import native

    if native.lib() is not None:
        return _emit_single_topn_native(writer, batch, results, stats,
                                        strata, read_len)
    from nextgenmap_tpu.io.sam import FLAG_SECONDARY

    cols = [
        {f: np.asarray(getattr(r, f)) for f in (
            "mapped", "strand", "pos", "mapq", "score", "ops", "n_ops",
            "q_start", "q_end", "matches",
        )} for r in results
    ]
    stats.kmer_fanout_overflow += int(results[0].fanout_overflow)
    stats.cmr_overflow += int(results[0].cmr_overflow)
    for i in range(batch.n):
        stats.reads_in += 1
        L = int(batch.lengths[i])
        if not cols[0]["mapped"][i]:
            stats.reads_unmapped += 1
            writer.write_unmapped(batch.names[i], batch.codes[i, :L], batch.quals[i])
            continue
        stats.reads_mapped += 1
        best_score = int(cols[0]["score"][i])
        emitted_pos: list[int] = []
        for j, c in enumerate(cols):
            if not c["mapped"][i]:
                break
            score = int(c["score"][i])
            if score <= 0 or (strata and score < best_score):
                break
            pos = int(c["pos"][i])
            if any(abs(pos - p) <= read_len for p in emitted_pos):
                continue  # same locus as a better alignment
            emitted_pos.append(pos)
            st = int(c["strand"][i])
            codes = batch.codes[i, :L]
            aligned = revcomp_codes(codes) if st else codes
            no = int(c["n_ops"][i])
            ident = float(c["matches"][i]) / max(1, no)
            writer.write_mapped(
                batch.names[i], aligned, batch.quals[i], L, st,
                pos, int(c["mapq"][i]) if j == 0 else 0, score,
                c["ops"][i], no, int(c["q_start"][i]), int(c["q_end"][i]),
                ident, flag_extra=0 if j == 0 else FLAG_SECONDARY,
            )


def _start_fetch(res):
    """Kick off device->host copies for every result leaf, concurrently.

    Without this, each np.asarray in the emitter is a separate synchronous
    device-to-host copy.  Issued right after dispatch, the copies overlap
    the NEXT batch's device compute and each other.
    """
    import jax as _j

    for leaf in _j.tree_util.tree_leaves(res):
        try:
            leaf.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass
    return res


def _make_start_fetch(n_devices: int):
    """Single-buffer wire fetch (utils/wire.py) when eligible: one fetch
    round-trip instead of one per result leaf.  NGM_WIRE=0 restores the
    per-leaf async path for A/B.

    Mesh paths (dp / (dp,ish) on one process) pack too: every shard is
    addressable, the pack program's gather rides ICI, and the host still
    sees ONE buffer.  Only results with NON-addressable shards (a true
    multi-host global array, where np.asarray itself would raise) fall
    back to the per-leaf path — checked on the first result and latched.
    """
    if os.environ.get("NGM_WIRE", "1") == "0":
        return _start_fetch

    import jax as _j

    from nextgenmap_tpu.utils.wire import fetch_packed

    state = {"ok": True, "checked": False}

    def start_fetch(res):
        if state["ok"] and not state["checked"]:
            state["checked"] = True
            for leaf in _j.tree_util.tree_leaves(res):
                if not getattr(leaf, "is_fully_addressable", True):
                    log.info("wire fetch off: result shards span processes")
                    state["ok"] = False
                    break
        if state["ok"]:
            return fetch_packed(res)
        return _start_fetch(res)

    return start_fetch


class _PoolEmitter:
    """Parallel render, ORDERED commit (the writer-mutex analog scaled out).

    N pool workers run render(args) -> rendered concurrently (the native SAM
    formatter releases the GIL, so renders truly overlap); one committer
    thread applies commit(rendered, args) strictly in submit order, so the
    output file is byte-identical to the serial emitter.  With the device
    step no longer the bottleneck (round 3), host-side formatting is — this
    splits it across -t threads while keeping writes and resume bookkeeping
    sequential.
    """

    def __init__(self, workers: int, render, commit):
        import queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        self.pool = ThreadPoolExecutor(max_workers=workers)
        self.q: "queue.Queue" = queue.Queue(maxsize=workers + 2)
        self.render, self.commit = render, commit
        self.err: BaseException | None = None
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            fut, args = item
            try:
                if self.err is None:
                    self.commit(fut.result(), args)
                else:
                    fut.cancel()
            except BaseException as e:  # surfaced on next submit/close
                self.err = e

    def submit(self, fn_ignored, args) -> None:
        if self.err:
            raise self.err
        fut = self.pool.submit(self.render, args)
        self.q.put((fut, args))

    def close(self) -> None:
        self.q.put(None)
        self.t.join()
        self.pool.shutdown(wait=True)
        if self.err:
            raise self.err


class _Emitter:
    """Emission stage of the software pipeline (the reference's writer-thread
    analog, ref:src/FileWriter.cpp).

    threads <= 1: synchronous one-batch-delay emission (the delay lets the
    async D2H copies overlap the next batch's device compute).
    threads >= 2 (-t): a dedicated emitter thread drains a FIFO queue, so SAM
    formatting + file writes overlap BOTH the device step and the parse
    thread; ordering is preserved by the single worker + FIFO.  The native
    formatter releases the GIL during the C call, so this is real overlap.
    """

    def __init__(self, async_: bool):
        self.async_ = async_
        self.pending = None
        if async_:
            import queue
            import threading

            self.q: "queue.Queue" = queue.Queue(maxsize=3)
            self.err: BaseException | None = None
            self.t = threading.Thread(target=self._run, daemon=True)
            self.t.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            fn, args = item
            try:
                fn(args)
            except BaseException as e:  # surfaced on the next submit/close
                self.err = e
                # keep draining so producers blocked in q.put() (bounded
                # queue) can't deadlock against a dead worker; close()'s
                # None sentinel ends the drain
                while True:
                    item = self.q.get()
                    if item is None:
                        return

    def submit(self, fn, args) -> None:
        if self.async_:
            if self.err:
                raise self.err
            self.q.put((fn, args))
        else:
            if self.pending is not None:
                pfn, pargs = self.pending
                pfn(pargs)
            self.pending = (fn, args)

    def close(self) -> None:
        if self.async_:
            self.q.put(None)
            self.t.join()
            if self.err:
                raise self.err
        elif self.pending is not None:
            fn, args = self.pending
            self.pending = None
            fn(args)


def _prefetch(it, depth: int = 2, stats: MappingStats | None = None):
    """Run a generator on a background thread, `depth` items ahead.

    Reference analog: the ReadProvider feeding worker threads
    (ref:src/ReadProvider.cpp) — here one parse thread keeps fixed-shape
    batches ready so FASTQ parsing overlaps device compute.
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    DONE = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(DONE)
        except BaseException as e:  # surface parse errors in the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        t0 = time.perf_counter()
        item = q.get()
        if stats is not None:
            stats.add_time("parse_wait", time.perf_counter() - t0)
        if item is DONE:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def run_mapping(
    cfg: NgmConfig,
    ref_path: str,
    qry: str | None = None,
    qry1: str | None = None,
    qry2: str | None = None,
    paired_interleaved: bool = False,
    out_path: str | None = None,
    cmdline: str = "",
    resume: bool = False,
    profile_dir: str = "",
) -> MappingStats:
    """Map reads end-to-end.

    Checkpoint/resume (SURVEY.md §5.4): after every emitted batch a sidecar
    `<out>.ngmt-progress.json` records reads-emitted + a config hash; with
    resume=True a matching incomplete sidecar re-enters the input at that
    read boundary and appends to the output (mapping is per-read
    deterministic, so restart is idempotent at batch granularity).
    """
    import hashlib
    import json
    import os

    cfg.validate()
    # data-parallel mapping needs the batch divisible by 2 * n_devices
    # (pairs must not straddle device shards); normalize BEFORE the config
    # hash so resume stays consistent
    import jax as _jax

    # -- multi-host sharding (SURVEY.md §2.3/§5.8; parallel/distributed.py):
    # this process maps read batches b with b % nprocs == procid into a
    # .part file; process 0 merges parts back into input order at the end.
    # With --shard-across-hosts the model flips: the INDEX is what is split
    # across processes (each holds only its shard), every process maps EVERY
    # batch through the global mesh, and only process 0 emits output --
    dist = cfg.dist_nprocs > 1 and not cfg.shard_hosts
    final_out = out_path
    if cfg.shard_hosts and cfg.dist_nprocs > 1:
        if resume:
            # every process must dispatch the identical batch sequence
            # (collectives are lockstep); a proc-0-only input rewind would
            # desynchronize the mesh
            raise ValueError("--resume is not supported with "
                             "--shard-across-hosts; rerun the mapping")
        from nextgenmap_tpu.parallel import distributed as dist_mod

        dist_mod.init_distributed(
            cfg.dist_coordinator, cfg.dist_nprocs, cfg.dist_procid
        )
        if cfg.dist_procid != 0:
            # non-emitting participant: still runs every device step (its
            # shard's side of the collectives) but writes no output
            out_path = os.devnull
    if dist:
        from nextgenmap_tpu.parallel import distributed as dist_mod

        if cfg.dist_coordinator:
            dist_mod.init_distributed(
                cfg.dist_coordinator, cfg.dist_nprocs, cfg.dist_procid
            )
        if out_path in (None, "-"):
            raise ValueError("multi-host mapping requires -o <file>")
        # parts are always SAM text; --bam is applied by process 0's merge
        out_path = dist_mod.part_path(final_out, cfg.dist_procid, cfg.dist_nprocs)

    ndev = cfg.devices or len(_jax.local_devices())
    if ndev > 1:
        m = 2 * ndev
        bs = ((cfg.batch_size + m - 1) // m) * m
        if bs != cfg.batch_size:
            log.info("batch_size %d -> %d (multiple of 2 x %d devices)",
                     cfg.batch_size, bs, ndev)
            cfg = cfg.replace(batch_size=bs)
    genome, index = load_reference(cfg, ref_path)

    first_file = qry or qry1
    assert first_file, "no query reads given"
    read_len = cfg.read_len or peek_read_len(first_file)
    log.info("read length (padded): %d", read_len)
    # sharded index: build-or-load the per-shard artifact here (needs
    # read_len for the halo; memoized like the reference's .ngm files)
    if cfg.shard_hosts:
        from nextgenmap_tpu.parallel.index_shard import (
            global_ish_mesh, local_shard_ids, open_sharded_local,
        )

        own = local_shard_ids(global_ish_mesh(cfg.index_shards))
        index = open_sharded_local(cfg, ref_path, genome, own)
    elif cfg.index_shards > 1 and index is not None:
        from nextgenmap_tpu.parallel.index_shard import ShardedIndex, open_sharded

        if not isinstance(index, ShardedIndex):
            index = open_sharded(cfg, ref_path, genome, index)
    # long reads (ref supports ~36-1000 bp): per-read DP state scales
    # L x corridor, so shrink the batch to keep the traceback direction
    # matrix bounded — deterministic from the input, so resume-safe
    if read_len > 250 and cfg.batch_size == NgmConfig().batch_size:
        m = 2 * max(1, ndev)
        eff = max(m * 8, cfg.batch_size * 150 // read_len // m * m)
        if eff != cfg.batch_size:
            log.info("long reads (%d bp): batch_size %d -> %d",
                     read_len, cfg.batch_size, eff)
            cfg = cfg.replace(batch_size=eff)

    # -- checkpoint/resume bookkeeping --
    progress_path = (
        f"{out_path}.ngmt-progress.json"
        if out_path not in (None, "-", os.devnull) else None
    )
    # the hash covers mapping SEMANTICS; the input window (qry_start/count)
    # is exactly what resume adjusts, and flags that change no record bytes
    # (merge/progress/threads/memoization) must not invalidate a checkpoint
    cfg_sha = hashlib.sha1(
        cfg.replace(
            qry_start=0, qry_count=0, no_merge=False, no_progress=False,
            threads=1, skip_save=False,
        ).to_json().encode()
    ).hexdigest()
    skip = max(0, cfg.qry_start)
    count = max(0, cfg.qry_count)
    prior = 0
    append = False
    own_done = 0                    # multi-host: own batches already emitted
    saved_batch_lines: list[int] = []
    saved_batch_bytes: list[int] = []
    restored_ob = 0
    if resume and progress_path and os.path.exists(progress_path):
        try:
            p = json.load(open(progress_path))
        except (OSError, ValueError):
            p = {}
        if (
            p.get("config_sha") == cfg_sha
            and not p.get("complete")
            and os.path.exists(out_path)
            # BGZF cannot be appended record-wise, but multi-host parts are
            # always SAM text (the merge encodes BAM), so dist+bam resumes
            and (not cfg.bam or dist)
        ):
            prior = int(p.get("reads_emitted", 0))
            if dist:
                # per-part resume (SURVEY.md §5.4 per-host cursors): this
                # process skips its own already-emitted batches; the sidecar
                # carries the per-batch line/byte ledger the merge needs
                saved_batch_lines = list(p.get("batch_lines") or [])
                saved_batch_bytes = list(p.get("batch_bytes") or [])
                own_done = len(saved_batch_lines)
            else:
                skip += prior
                if count:
                    count = max(0, count - prior)
            append = prior > 0
            # a kill mid-batch leaves partial records past the checkpoint;
            # drop them so the in-flight batch re-emits idempotently
            # (SURVEY.md §5.4)
            ob = p.get("out_bytes")
            if append and ob is not None and os.path.getsize(out_path) > ob:
                with open(out_path, "r+") as tf:
                    tf.truncate(ob)
                log.info("truncated %s to checkpointed %d bytes", out_path, ob)
            restored_ob = int(ob or 0)
            log.info("resuming after %d already-emitted reads", prior)

    def save_progress(complete: bool = False) -> None:
        if progress_path is None:
            return
        # crash consistency: the output stream is buffered, so it must hit
        # the OS before the sidecar claims its records were emitted — a
        # SIGKILL between the two would otherwise lose records that resume
        # then skips (tests/test_resume.py kill test)
        flush = getattr(out, "flush", None)
        if flush is not None:
            flush()
        try:  # byte offset of the checkpoint: resume truncates back to it
            out_bytes = getattr(out, "out", out).tell()
        except (OSError, ValueError, AttributeError):
            out_bytes = None
        tmp = progress_path + ".tmp"
        doc = {
            "reads_emitted": prior + stats.reads_in,
            "config_sha": cfg_sha,
            "out_bytes": out_bytes,
            "complete": complete,
        }
        if dist:
            # the per-batch ledger the round-robin merge interleaves by;
            # persisted so a per-part resume can continue it
            doc["batch_lines"] = batch_lines
            doc["batch_bytes"] = batch_bytes
            doc["header_lines"] = header_lines
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, progress_path)

    mapper = Mapper(cfg, genome, read_len, index)
    start_fetch = _make_start_fetch(mapper.n_devices)
    stats = MappingStats()
    if cfg.bam and not dist:
        from nextgenmap_tpu.io.bam import BamTextWriter

        if out_path in (None, "-"):
            raise ValueError("--bam requires -o <file>")
        out = BamTextWriter(out_path)
    else:
        out = open(out_path, "a", buffering=1 << 20) if append else open_output(out_path)
    if dist:
        from nextgenmap_tpu.parallel.distributed import CountingWriter

        out = CountingWriter(
            out,
            lines=(int(p.get("header_lines", 0)) + sum(saved_batch_lines))
            if append else 0,
            nbytes=restored_ob if append else 0,
        )
    writer = SamWriter(genome, cfg, out, cmdline)
    if not append:
        writer.write_header()
    header_lines = (
        (int(p.get("header_lines", 0)) if append else out.lines)
        if dist else 0
    )
    batch_lines: list[int] = list(saved_batch_lines)
    batch_bytes: list[int] = list(saved_batch_bytes)
    header_bytes = (out.nbytes - sum(batch_bytes)) if dist else 0

    def record_batch_lines() -> None:
        if dist:
            batch_lines.append(out.lines - header_lines - sum(batch_lines))
            batch_bytes.append(out.nbytes - header_bytes - sum(batch_bytes))

    cells_per_aln = read_len * mapper.band  # for the GCUPS counter

    def account(res, batch):
        n_aln = int(np.asarray(res.n_candidates).sum())
        stats.alignments_computed += n_aln
        stats.cells_computed += (n_aln + batch.n) * cells_per_aln

    paired = qry1 is not None or paired_interleaved
    t0 = time.time()
    stats.start_time = t0
    # tracing/profiling (SURVEY.md §5.1): the mapping loop is wrapped in a
    # jax.profiler trace viewable in Perfetto/XProf
    import jax as _jx
    if profile_dir:
        _jx.profiler.start_trace(profile_dir)
    def after_emit(res, batch):
        account(res, batch)
        stats.mark_batch()
        record_batch_lines()
        save_progress()
        if not cfg.no_progress:
            log.info(
                "processed %d reads (%.0f reads/s, %.2f GCUPS)",
                stats.reads_in, stats.reads_per_sec(), stats.gcups(),
            )

    # software pipeline (the reference's thread pipeline analog, SURVEY.md §2
    # component 14/15): a parse thread keeps batches ready; batch i+1 is
    # DISPATCHED to the device (async under JAX) before batch i's results are
    # emitted; with -t >= 2 emission itself moves to a dedicated thread so
    # parse, device compute, and SAM formatting all overlap
    def run_megabatched(batches_it, K, paired, emit):
        """--megabatch K: group K batches per dispatch (map_step_scan — one
        program execution and one result fetch per K batches).  The tail
        group is PADDED with replicas of its last batch (compiling a
        separate single-batch program for one tail costs far more than the
        wasted rows); padded rows are never emitted, so output is
        byte-identical to the per-batch loop."""

        def emit_group(pending):
            group, res_k = pending
            host = type(res_k)(*[np.asarray(f) for f in res_k])
            for i, b in enumerate(group):
                emit((b, type(res_k)(*[f[i] for f in host])))

        def flush(group):
            n = len(group)
            t0 = time.perf_counter()
            codes_k = np.stack([b.codes for b in group]
                               + [group[-1].codes] * (K - n))
            lens_k = np.stack([b.lengths for b in group]
                              + [group[-1].lengths] * (K - n))
            res_k = start_fetch(
                mapper.map_batch_scan(codes_k, lens_k, paired=paired)
            )
            t1 = time.perf_counter()
            stats.add_time("dispatch", t1 - t0)
            emitter.submit(emit_group, (group, res_k))
            stats.add_time("emit_wait", time.perf_counter() - t1)

        group: list = []
        for batch in batches_it:
            group.append(batch)
            if len(group) == K:
                flush(group)
                group = []
        if group:
            flush(group)
        emitter.close()

    def shim_writer():
        """A writer clone that renders into a buffer (parallel-safe); the
        ordered committer writes the buffer to the real sink."""
        import dataclasses as _dc
        import io as _io

        return _dc.replace(writer, out=_io.StringIO()), MappingStats()

    def group_wrap(render_one, commit_one):
        """Lift per-batch (render, commit) to megabatch GROUPS so the pool
        renders whole groups in parallel workers (one host conversion of the
        group's wire buffer per worker, K per-batch renders inside), while
        the ordered committer keeps output bytes and resume bookkeeping
        identical to the serial emitter."""

        def render_g(pending):
            group, res_k = pending
            host = type(res_k)(*[np.asarray(f) for f in res_k])
            outs = []
            for i, b in enumerate(group):
                p = (b, type(res_k)(*[f[i] for f in host]))
                outs.append((render_one(p), p))
            return outs

        def commit_g(rendered, pending):
            for r, p in rendered:
                commit_one(r, p)

        return render_g, commit_g

    def make_emitter(render=None, commit=None):
        if render is not None and cfg.threads >= 3:
            log.info("parallel emitter pool (%d render workers)",
                     cfg.threads - 1)
            if cfg.megabatch > 1:
                return _PoolEmitter(cfg.threads - 1,
                                    *group_wrap(render, commit))
            return _PoolEmitter(cfg.threads - 1, render, commit)
        return _Emitter(async_=cfg.threads > 1)

    if cfg.threads > 1:
        log.info("emitter thread enabled (-t %d)", cfg.threads)
    prefetch_depth = max(2, cfg.threads)
    if not paired:
        topn = max(1, cfg.topn)
        batches = batch_single(qry, cfg.batch_size, read_len, skip, count)
        if dist:
            import itertools

            from nextgenmap_tpu.parallel.distributed import shard_batches

            batches = shard_batches(batches, cfg.dist_procid, cfg.dist_nprocs)
            if own_done:
                batches = itertools.islice(batches, own_done, None)

        def emit(pending):
            batch, res = pending
            if topn > 1:
                emit_single_topn(writer, batch, res, stats,
                                 cfg.strata, read_len)
                after_emit(res[0], batch)
            else:
                emit_single(writer, batch, res, stats)
                after_emit(res, batch)

        def render_se(pending):
            batch, res = pending
            shim, dst = shim_writer()
            emit_single(shim, batch, res, dst)
            return shim.out.getvalue(), dst

        def commit_se(rendered, pending):
            batch, res = pending
            text, dst = rendered
            t0 = time.perf_counter()
            writer.out.write(text)
            stats.add_time("write", time.perf_counter() - t0)
            stats.merge_counters(dst)
            after_emit(res, batch)

        emitter = make_emitter(
            *( (render_se, commit_se) if topn == 1 else (None, None) )
        )
        if cfg.megabatch > 1 and topn == 1 and mapper.supports_megabatch():
            run_megabatched(
                _prefetch(batches, depth=prefetch_depth, stats=stats),
                cfg.megabatch, False, emit,
            )
        else:
            for batch in _prefetch(batches, depth=prefetch_depth, stats=stats):
                t0 = time.perf_counter()
                res = start_fetch(
                    mapper.map_batch_topn(batch.codes, batch.lengths)
                    if topn > 1 else mapper.map_batch(batch.codes, batch.lengths)
                )
                t1 = time.perf_counter()
                stats.add_time("dispatch", t1 - t0)
                emitter.submit(emit, (batch, res))
                stats.add_time("emit_wait", time.perf_counter() - t1)
            emitter.close()
    else:
        from nextgenmap_tpu.pair.resolve import emit_paired

        if skip % 2 or count % 2:
            raise ValueError("paired qry-start/qry-count/resume must be even")
        batches = batch_paired(qry1 or qry, qry2, cfg.batch_size, read_len,
                               skip, count)
        if dist:
            import itertools

            from nextgenmap_tpu.parallel.distributed import shard_batches

            batches = shard_batches(batches, cfg.dist_procid, cfg.dist_nprocs)
            if own_done:
                batches = itertools.islice(batches, own_done, None)

        def emit_pe(pending):
            pb, pr = pending
            emit_paired(writer, pb, pr, stats)
            after_emit(pr, pb)

        def render_pe(pending):
            pb, pr = pending
            shim, dst = shim_writer()
            emit_paired(shim, pb, pr, dst)
            return shim.out.getvalue(), dst

        def commit_pe(rendered, pending):
            pb, pr = pending
            text, dst = rendered
            t0 = time.perf_counter()
            writer.out.write(text)
            stats.add_time("write", time.perf_counter() - t0)
            stats.merge_counters(dst)
            after_emit(pr, pb)

        emitter = make_emitter(render_pe, commit_pe)
        if cfg.megabatch > 1 and mapper.supports_megabatch():
            run_megabatched(
                _prefetch(batches, depth=prefetch_depth, stats=stats),
                cfg.megabatch, True, emit_pe,
            )
        else:
            for batch in _prefetch(batches, depth=prefetch_depth, stats=stats):
                t0 = time.perf_counter()
                res = start_fetch(
                    mapper.map_batch_paired(batch.codes, batch.lengths)
                )
                t1 = time.perf_counter()
                stats.add_time("dispatch", t1 - t0)
                emitter.submit(emit_pe, (batch, res))
                stats.add_time("emit_wait", time.perf_counter() - t1)
            emitter.close()
    if profile_dir:
        _jx.profiler.stop_trace()
        log.info("profiler trace written to %s", profile_dir)
    if stats.timing:
        log.info(
            "host phase seconds: %s",
            {k: round(v, 2) for k, v in sorted(stats.timing.items())},
        )
    save_progress(complete=True)
    if cfg.bam or out_path not in (None, "-"):
        out.close()
    if dist:
        from nextgenmap_tpu.parallel import distributed as dist_mod

        sd = {k: v for k, v in vars(stats).items()
              if isinstance(v, (int, float)) and k != "start_time"}
        dist_mod.write_manifest(
            final_out, cfg.dist_procid, cfg.dist_nprocs,
            header_lines, batch_lines, sd, complete=True,
            batch_bytes=batch_bytes,
        )
        if cfg.dist_procid == 0 and not cfg.no_merge:
            totals = dist_mod.merge_parts(final_out, cfg.dist_nprocs,
                                          bam=cfg.bam)
            log.info(
                "done (all %d hosts): reads: %d  mapped: %d  unmapped: %d",
                cfg.dist_nprocs, totals.get("reads_in", 0),
                totals.get("reads_mapped", 0), totals.get("reads_unmapped", 0),
            )
            return stats
    log.info("done: %s", stats.summary())
    return stats
