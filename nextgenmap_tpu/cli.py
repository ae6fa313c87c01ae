"""``ngm-tpu`` command line — NGM's flag surface (SURVEY.md §2.1).

Reference analog: main()/ArgParser (ref:src/main.cpp, ref:src/ArgParser.cpp).
Unlike the reference (which indexes implicitly on first use) an explicit
``index`` verb is also provided; plain invocation maps, like ``ngm``.
"""

from __future__ import annotations

import shlex
import sys

from nextgenmap_tpu.config import NgmConfig
from nextgenmap_tpu.utils.logging import get_logger

log = get_logger("ngm-tpu.cli")


def build_parser():
    import argparse

    D = NgmConfig()  # single source of truth for every default

    p = argparse.ArgumentParser(
        prog="ngm-tpu",
        description="JAX short-read mapper (NextGenMap capabilities)",
    )
    sub = p.add_subparsers(dest="verb")

    def add_common(sp):
        g = sp.add_argument_group("input/output")
        g.add_argument("-r", "--reference", required=True)
        g.add_argument("-q", "--qry")
        g.add_argument("-1", "--qry1", dest="qry1")
        g.add_argument("-2", "--qry2", dest="qry2")
        g.add_argument("-p", "--paired", action="store_true",
                       help="interleaved paired-end input via -q")
        g.add_argument("-o", "--output")
        g.add_argument("--bam", action="store_true")
        g.add_argument("--no-unal", action="store_true")
        g.add_argument("--hard-clip", action="store_true")
        g.add_argument("--silent-clip", action="store_true")
        g.add_argument("--rg-id", default="")
        g.add_argument("--rg-sm", default="")
        g.add_argument("--rg-lb", default="")
        g.add_argument("--rg-pl", default="")
        g.add_argument("--rg-pu", default="")
        g.add_argument("--skip-save", action="store_true")

        g = sp.add_argument_group("index")
        g.add_argument("-k", "--kmer", type=int, default=D.kmer)
        g.add_argument("--kmer-skip", type=int, default=D.kmer_skip)
        g.add_argument("--read-kmer-skip", type=int, default=None,
                       help="read-side k-mer stride (default: config; drops "
                            "to 1 automatically when --kmer-skip > 1)")
        g.add_argument("--kmer-min", type=int, default=D.kmer_min)
        g.add_argument("--max-freq", type=int, default=D.max_kmer_freq)
        g.add_argument("--max-cmrs", type=int, default=D.max_cmrs)
        g.add_argument("--max-read-hits", type=int, default=D.max_read_hits,
                       help="per-read index-hit cap (0 = auto from genome size)")
        g.add_argument("--index-shards", type=int, default=D.index_shards,
                       help="split the index/genome into N position-range "
                            "shards (gigabase genomes); N devices map them "
                            "in parallel, one device loops them sequentially")

        g = sp.add_argument_group("sensitivity/filters")
        g.add_argument("-s", "--sensitivity", type=float, default=D.sensitivity)
        g.add_argument("-i", "--min-identity", type=float, default=D.min_identity)
        g.add_argument("-R", "--min-residues", type=float, default=D.min_residues)
        g.add_argument("-n", "--topn", type=int, default=D.topn)
        g.add_argument("--strata", action="store_true")

        g = sp.add_argument_group("scoring")
        g.add_argument("--match-bonus", type=int, default=D.match_bonus)
        g.add_argument("--mismatch-penalty", type=int, default=D.mismatch_penalty)
        g.add_argument("--gap-read-penalty", type=int, default=D.gap_read_penalty)
        g.add_argument("--gap-ref-penalty", type=int, default=D.gap_ref_penalty)
        g.add_argument("--gap-extend-penalty", type=int,
                       default=D.gap_extend_penalty)
        g.add_argument("--affine", action="store_true",
                       help="accepted for reference compatibility: the "
                            "banded-SW kernel is ALWAYS affine (requires "
                            "gap open >= gap extend; extend > open is "
                            "rejected at validation)")
        g.add_argument("--end-to-end", action="store_true",
                       help="whole-read (glocal) alignment, no soft clipping")

        g = sp.add_argument_group("paired-end")
        g.add_argument("-I", "--min-insert-size", type=int, default=D.min_insert_size)
        g.add_argument("-X", "--max-insert-size", type=int, default=D.max_insert_size)
        g.add_argument("--pair-score-cutoff", type=float,
                       default=D.pair_score_cutoff)

        g = sp.add_argument_group("modes")
        g.add_argument("--bs-mapping", action="store_true")
        g.add_argument("--bs-cutoff", type=int, default=D.bs_cutoff)
        g.add_argument("--slam-seq", type=int, default=0, choices=[0, 1, 2])

        g = sp.add_argument_group("runtime")
        g.add_argument("-t", "--threads", type=int, default=D.threads)
        g.add_argument("--devices", type=int, default=D.devices,
                       help="devices for data-parallel mapping (0 = all)")
        g.add_argument("-g", "--gpu", metavar="IDS", default=None,
                       help="reference-compatible accelerator selector "
                            "(comma-separated ids); only the COUNT is "
                            "used: '-g 1,3' = data-parallel over the first "
                            "2 devices")
        g.add_argument("--batch-size", type=int, default=D.batch_size)
        g.add_argument("--megabatch", type=int, default=D.megabatch,
                       help="fold K read batches into one device program "
                            "(one dispatch per K batches; 0 = off)")
        g.add_argument("--read-len", type=int, default=0,
                       help="static padded read length (0 = infer)")
        g.add_argument("--corridor", type=int, default=0)
        g.add_argument("--no-progress", action="store_true")
        g.add_argument("--qry-start", type=int, default=0,
                       help="skip the first N input reads")
        g.add_argument("--qry-count", type=int, default=0,
                       help="map at most N reads (0 = all)")
        g.add_argument("--resume", action="store_true",
                       help="continue an interrupted run from its "
                            "<out>.ngmt-progress.json checkpoint")
        g.add_argument("--profile", metavar="DIR", default="",
                       help="capture a jax.profiler (Perfetto/XProf) trace "
                            "of the mapping loop into DIR")

        g = sp.add_argument_group(
            "multi-host", "run one process per host with the same command "
            "+ its --dist-procid; process 0 merges the output shards")
        g.add_argument("--dist-nprocs", type=int, default=D.dist_nprocs)
        g.add_argument("--dist-procid", type=int, default=D.dist_procid)
        g.add_argument("--dist-coordinator", default="",
                       help="host:port for jax.distributed.initialize "
                            "(only needed for cross-host collectives)")
        g.add_argument("--no-merge", action="store_true",
                       help="leave per-host .part outputs unmerged")
        g.add_argument("--shard-across-hosts", action="store_true",
                       help="with --index-shards N: the shards live on "
                            "different hosts (global mesh via "
                            "--dist-coordinator); every process maps every "
                            "batch, each holding ONLY its own index shard; "
                            "process 0 writes the single output")

    map_p = sub.add_parser("map", help="map reads (default verb)")
    add_common(map_p)
    idx_p = sub.add_parser("index", help="build (and memoize) the index only")
    idx_p.add_argument("-r", "--reference", required=True)
    idx_p.add_argument("-k", "--kmer", type=int, default=D.kmer)
    idx_p.add_argument("--kmer-skip", type=int, default=D.kmer_skip)
    idx_p.add_argument("--max-freq", type=int, default=D.max_kmer_freq)
    idx_p.add_argument("--bs-mapping", action="store_true")
    idx_p.add_argument("--index-shards", type=int, default=D.index_shards,
                       help="also pre-build the .ngmt-shards artifact so a "
                            "later `map --index-shards N` does zero index "
                            "work (gigabase split costs minutes)")
    idx_p.add_argument("-X", "--max-insert-size", type=int,
                       default=D.max_insert_size,
                       help="keys the shard halo; use the same value at map "
                            "time to reuse the artifact")
    return p, map_p


def config_from_args(a) -> NgmConfig:
    devices = a.devices
    if getattr(a, "gpu", None):
        # ref -g takes explicit device ids; the mesh uses the first N local
        # devices, so only the COUNT carries over
        devices = len([x for x in a.gpu.split(",") if x != ""])
    rks = a.read_kmer_skip
    if rks is None:
        # reference-style genome striding (--kmer-skip > 1) implies stride-1
        # read enumeration; otherwise use the read-side stride default
        rks = 1 if a.kmer_skip > 1 else NgmConfig().read_kmer_skip
    return NgmConfig(
        kmer=a.kmer, kmer_skip=a.kmer_skip, read_kmer_skip=rks,
        kmer_min=a.kmer_min,
        max_kmer_freq=a.max_freq, max_cmrs=a.max_cmrs,
        max_read_hits=a.max_read_hits,
        sensitivity=a.sensitivity, min_identity=a.min_identity,
        min_residues=a.min_residues, topn=a.topn, strata=a.strata,
        match_bonus=a.match_bonus, mismatch_penalty=a.mismatch_penalty,
        gap_read_penalty=a.gap_read_penalty, gap_ref_penalty=a.gap_ref_penalty,
        gap_extend_penalty=a.gap_extend_penalty, affine=a.affine,
        end_to_end=a.end_to_end,
        min_insert_size=a.min_insert_size, max_insert_size=a.max_insert_size,
        pair_score_cutoff=a.pair_score_cutoff,
        bs_mapping=a.bs_mapping, bs_cutoff=a.bs_cutoff, slam_seq=a.slam_seq,
        no_unal=a.no_unal, hard_clip=a.hard_clip, silent_clip=a.silent_clip,
        rg_id=a.rg_id, rg_sm=a.rg_sm, rg_lb=a.rg_lb, rg_pl=a.rg_pl,
        rg_pu=a.rg_pu, bam=a.bam,
        batch_size=a.batch_size, megabatch=a.megabatch,
        read_len=a.read_len, corridor=a.corridor,
        skip_save=a.skip_save, no_progress=a.no_progress, threads=a.threads,
        devices=devices,
        qry_start=a.qry_start, qry_count=a.qry_count,
        dist_nprocs=a.dist_nprocs, dist_procid=a.dist_procid,
        dist_coordinator=a.dist_coordinator, no_merge=a.no_merge,
        index_shards=a.index_shards, shard_hosts=a.shard_across_hosts,
    )


def main(argv: list[str] | None = None) -> int:
    from nextgenmap_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    argv = list(sys.argv[1:] if argv is None else argv)
    # default verb is `map` (like the reference binary)
    if argv and argv[0] not in ("map", "index", "-h", "--help"):
        argv = ["map"] + argv
    parser, _ = build_parser()
    a = parser.parse_args(argv)

    if a.verb == "index":
        from nextgenmap_tpu.index.genome import Genome
        from nextgenmap_tpu.index.kmer_index import KmerIndex

        genome = Genome.open(a.reference)
        modes = ("ct", "ga") if a.bs_mapping else ("none",)
        sharded = a.index_shards > 1
        built = [
            KmerIndex.open(
                a.reference, genome.codes, genome.sha1(),
                k=a.kmer, skip=a.kmer_skip, max_freq=a.max_freq,
                collapse=collapse,
                # both the unsharded fast path and position-range sharding
                # use the canonical index (shards slice (pos<<1)|flip
                # entries with doubled bounds); sharding tolerates global
                # entries up to uint32 since per-shard rebasing restores
                # int32
                canonical=(collapse == "none" and genome.codes.shape[0]
                           < (2**31 if sharded else 2**30)),
                allow_u32=sharded,
            )
            for collapse in modes
        ]
        if sharded:
            from nextgenmap_tpu.parallel.index_shard import (
                ShardedIndex, open_sharded,
            )

            cfg = NgmConfig(
                kmer=a.kmer, kmer_skip=a.kmer_skip, max_kmer_freq=a.max_freq,
                bs_mapping=a.bs_mapping, index_shards=a.index_shards,
                max_insert_size=a.max_insert_size,
            )
            sidx = open_sharded(cfg, a.reference, genome,
                                tuple(built) if a.bs_mapping else built[0])
            # ALSO write per-shard artifacts so `map --shard-across-hosts`
            # processes each load only their own shard (no global CSR touch)
            halo = ShardedIndex.halo_for(cfg)
            path_for = lambda s: ShardedIndex.shard_cache_path(
                a.reference, s, cfg.kmer, cfg.kmer_skip, cfg.index_shards,
                halo, cfg.max_kmer_freq, dual=cfg.bs_mapping,
                canonical=sidx.canonical,
            )
            sidx.save_shards(path_for, genome.sha1())
        return 0

    if not (a.qry or a.qry1):
        parser.error("need -q or -1/-2 query reads")
    if a.paired and a.qry1:
        parser.error("-p (interleaved) conflicts with -1/-2")
    if bool(a.qry1) != bool(a.qry2):
        parser.error("-1 and -2 must be given together")
    cfg = config_from_args(a)
    from nextgenmap_tpu.pipeline.runner import run_mapping

    stats = run_mapping(
        cfg, a.reference,
        qry=a.qry, qry1=a.qry1, qry2=a.qry2,
        paired_interleaved=a.paired,
        out_path=a.output,
        cmdline=shlex.join(["ngm-tpu"] + argv),
        resume=a.resume,
        profile_dir=a.profile,
    )
    log.info("exit: %s", stats.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
