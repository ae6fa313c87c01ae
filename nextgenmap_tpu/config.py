"""Run configuration — the single source of truth for every subsystem.

Reference analog: the ``_Config`` singleton (ref:src/Config.cpp) populated by
the CLI (ref:src/ArgParser.cpp).  Here it is one frozen dataclass: hashable
(so it can key jit caches where it changes kernel shapes), JSON-serializable
(dumped next to outputs for reproducibility), and with NGM's flag surface
(SURVEY.md §2.1) mapped 1:1 onto fields.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class NgmConfig:
    # --- index (ref flags: -k/--kmer, --kmer-skip, --max-freq analog) ---
    kmer: int = 13                # k in [10, 14], reference default 13
    kmer_skip: int = 1            # stride between indexed k-mers (ref --kmer-skip).
                                  # The reference defaults to 2 to halve index RAM;
                                  # on the device the cost is per-READ lookups, so
                                  # the default strides the read side instead —
                                  # same hits per locus, half the index traffic.
    read_kmer_skip: int = 2       # stride of k-mer enumeration on the READ side;
                                  # kmer_skip and read_kmer_skip must not both
                                  # exceed 1, else stride phases can miss a locus
    max_kmer_freq: int = 1000     # repeat masking: k-mers occurring more often are dropped
    kmer_min: int = 0             # minimum k-mer hits to consider a read mappable

    # --- candidate search ---
    sensitivity: float = 0.5      # [0,1]; CMR threshold = max(1, ceil(best_count * sensitivity))
                                  # higher => stricter threshold => fewer candidates (faster)
    max_cmrs: int = 32            # static cap on candidate regions per read/strand (ref --max-cmrs)
    max_kmer_fanout: int = 32     # static cap K on positions gathered per k-mer lookup
    max_read_hits: int = 0        # static cap H on total index hits compacted
                                  # per read (both strands); overflow counted.
                                  # 0 = auto from genome/index size (see
                                  # resolved_read_hits) — H sets the size of
                                  # the CS compaction, so size it to the
                                  # genome instead of worst-casing
    diag_bin_log2: int = 4        # diagonal bucket width = 2**this (16bp bins)

    # --- scoring (ref defaults: match 10, mismatch 15, gaps 20/20/20) ---
    match_bonus: int = 10
    mismatch_penalty: int = 15
    gap_read_penalty: int = 20    # gap opened in the read (deletion from ref view)
    gap_ref_penalty: int = 20     # gap opened in the reference
    gap_extend_penalty: int = 20  # NGM default == open => effectively linear gaps
    affine: bool = False          # ref --affine: accepted for compatibility;
                                  # the SW kernel is ALWAYS affine-gap
                                  # (open >= extend; validate() rejects
                                  # extend > open), so this changes nothing
    end_to_end: bool = False      # ref --end-to-end: whole read must align
                                  # (glocal DP, no soft clipping)

    # --- filters / selection ---
    min_identity: float = 0.65    # ref -i
    min_residues: float = 0.5     # ref -R (fraction of read aligned)
    topn: int = 1                 # ref -n
    strata: bool = False          # ref --strata: only top-score stratum

    # --- paired-end (ref -I/-X/--pair-score-cutoff) ---
    min_insert_size: int = 0
    max_insert_size: int = 1000
    pair_score_cutoff: float = 0.9

    # --- modes ---
    bs_mapping: bool = False      # bisulfite: C/T-collapsed hashing + asymmetric matrices
    bs_cutoff: int = 6
    slam_seq: int = 0             # 0 off, 1|2 T->C-tolerant scoring

    # --- output ---
    no_unal: bool = False         # suppress unmapped records
    hard_clip: bool = False
    silent_clip: bool = False
    rg_id: str = ""
    rg_sm: str = ""
    rg_lb: str = ""
    rg_pl: str = ""
    rg_pu: str = ""
    bam: bool = False

    # --- runtime / batching ---
    batch_size: int = 4096        # reads per device step (tuned on another
                                  # chip; not measured on the H100)
    megabatch: int = 0            # fold K batches into ONE device program
                                  # (lax.scan over [K,B,L]): one dispatch and
                                  # one result fetch per K batches; 0/1 = off.
                                  # Applies to the plain single-device path
                                  # (not topn/sharded/staged-long-read)
    read_len: int = 0             # 0 = infer from input; padded static length
    corridor: int = 0             # 0 = derive from read length
    skip_save: bool = False       # don't memoize index artifacts
    no_progress: bool = False
    threads: int = 1              # host IO threads (device work is bulk-synchronous)
    devices: int = 1              # devices for data-parallel mapping (0 = all);
                                  # the dp analog of the reference's -t workers
    qry_start: int = 0            # skip the first N input reads (ref --qry-start)
    qry_count: int = 0            # map at most N reads, 0 = all (ref --qry-count)

    # --- multi-host (new capability; SURVEY.md §2.3/§5.8 — reference is
    # single-node).  Launch one process per host with the same command plus
    # its --dist-procid; reads are round-robin batch-sharded, outputs merged
    # deterministically by process 0 (parallel/distributed.py).
    dist_nprocs: int = 1          # total processes (hosts) in the job
    dist_procid: int = 0          # this process's id [0, nprocs)
    dist_coordinator: str = ""    # host:port for jax.distributed (only needed
                                  # for cross-host collectives, e.g. a
                                  # pod-sharded index); empty = no global runtime
    no_merge: bool = False        # leave per-host .part files unmerged
    index_shards: int = 1         # split index+genome into S position ranges
                                  # (BASELINE config 4 / GRCh38): parallel over
                                  # an ("dp","ish") mesh when devices % S == 0,
                                  # else a sequential shard loop on one device
                                  # (how a >2^31-base genome fits int32 device
                                  # coordinates on a single device)
    shard_hosts: bool = False     # --shard-across-hosts: the index shards live
                                  # on DIFFERENT hosts (global ("dp","ish")
                                  # mesh via jax.distributed); each process
                                  # builds/loads ONLY its own shard(s) and
                                  # all processes map every batch together,
                                  # merging per-shard hits with cross-host
                                  # all_gather (north-star config 4 layout)

    # ------------------------------------------------------------------
    def corridor_for(self, read_len: int) -> int:
        """Banded-SW corridor width for a read length.

        Must cover the pair-merged diagonal-bucket span (2 * 2^diag_bin_log2,
        since a candidate covers bucket b and b+1) PLUS indel slack on both
        sides — ~10% divergence is the sensitivity regime the reference
        targets.  Rounded up to a multiple of 8.
        """
        bucket_span = 2 * (1 << self.diag_bin_log2)
        if self.corridor:
            return bucket_span + _round_up(self.corridor, 8)
        slack = max(16, _round_up(int(read_len * 0.15), 8))
        return bucket_span + slack

    def resolved_read_hits(self, n_positions: int, read_len: int,
                           collapsed: bool | None = None) -> int:
        """Static per-read hit cap H (0 = derive from index density).

        Expected CSR row length is positions/buckets; a read enumerates
        kmers_per_read rows, each capped at max_kmer_fanout.  2x the
        expectation covers repeat-rich loci; the clamp keeps the compaction
        tensors lane-friendly.  Overflow is always counted
        (MappingStats.kmer_fanout_overflow), so a too-small H is visible,
        never silent.

        collapsed (default: bs_mapping): the CT/GA-collapsed tables live in
        an effective 3^k bucket space — ~42x denser rows at k=13 than the
        4^k estimate.  Sizing H with 4^k there starves the SECOND (rc/GA)
        table's k-mers wholesale once the fwd pass fills every slot (hits
        compact in k-mer order), which silently unmapped every reverse
        bisulfite read at >Mb genome scale (round-3 bug).
        """
        if self.max_read_hits:
            return self.max_read_hits
        if collapsed is None:
            collapsed = self.bs_mapping
        buckets = (3.0 if collapsed else 4.0) ** self.kmer
        exp_row = n_positions / buckets
        # the cap covers BOTH strands (2x kmers_per_read lookups).  1.25x the
        # expected row length: at chr20 scale the tighter cap (H=192 vs the
        # old 1.5x's 256) kept truth accuracy identical at both 2% and 10%
        # SNPs on another chip — reads that overflow the cap are repeat-
        # dense and keep enough interleaved hits at their true locus, and
        # high-divergence reads produce FEWER hits, not more.  Truncation is
        # always counted (kmer_fanout_overflow), never silent.  The ceiling
        # bounds the compaction tensors; if the estimate exceeds it (gigabase
        # genome at k=13), raise k to 14 or shard the index.  Collapsed (bisulfite)
        # tables get a higher ceiling: their denser rows are the norm, and
        # the sort-based compaction handles large H
        ceil = 4608 if collapsed else 2048
        per_row = min(float(self.max_kmer_fanout), max(1.25, 1.25 * exp_row))
        est = 2 * self.kmers_per_read(read_len) * per_row
        return max(128, min(ceil, _round_up(int(est), 64)))

    def kmers_per_read(self, read_len: int) -> int:
        return max(1, (read_len - self.kmer) // self.read_kmer_skip + 1)

    def resolved_word_cap(self, n_positions: int, read_len: int,
                          hit_cap: int, *, canonical: bool = True) -> int:
        """Static per-read WORD budget HW for the word-gather CS path
        (ops/candidate.py WORD_W=8-wide position rows).

        A read's word count is the sum over its nonzero CSR rows of
        ceil(cnt/8) (+1 straddle).  Unlike random k-mers, a MATCHING read's
        k-mers ~always hit (the read came from the genome), so the expected
        nonzero-row count is ~every lookup, and each row adds ~min(lam,
        fanout)/8 extra words from index density lam (positions per offsets
        row).  1.25x margin + slack covers repeat-rich reads; overflow is
        counted in hit_overflow (never silent).  The win over hit_cap is the
        hits-per-word factor: H ~ lookups * row length but HW ~ lookups *
        (1 + row length / 8).
        """
        q = self.kmers_per_read(read_len)
        lookups = q if canonical else 2 * q
        lam = n_positions / 4.0 ** self.kmer
        per_row = 1.0 + min(lam, float(self.max_kmer_fanout)) / 8.0
        est = 1.25 * lookups * per_row + 8
        ceil_w = max(64, hit_cap // 2 + 16)
        return max(24, min(ceil_w, _round_up(int(est), 8)))

    def replace(self, **kw) -> "NgmConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "NgmConfig":
        return cls(**json.loads(s))

    def validate(self) -> None:
        if not (10 <= self.kmer <= 14):
            raise ValueError(f"kmer must be in [10,14], got {self.kmer}")
        if self.kmer_skip < 1 or self.read_kmer_skip < 1:
            raise ValueError("kmer strides must be >= 1")
        if self.kmer_skip > 1 and self.read_kmer_skip > 1:
            raise ValueError(
                "kmer_skip and read_kmer_skip cannot both exceed 1 "
                "(stride phases could miss a locus entirely)"
            )
        if not (0.0 <= self.sensitivity <= 1.0):
            raise ValueError("sensitivity must be in [0,1]")
        if self.max_insert_size < self.min_insert_size:
            raise ValueError("max_insert_size < min_insert_size")
        if self.slam_seq not in (0, 1, 2):
            raise ValueError("slam_seq must be 0, 1 or 2")
        if self.gap_extend_penalty > min(self.gap_read_penalty, self.gap_ref_penalty):
            # the banded-SW lazy-F scan trick requires open >= extend
            raise ValueError("gap_extend_penalty must be <= gap open penalties")
        if self.dist_nprocs < 1 or not (0 <= self.dist_procid < self.dist_nprocs):
            raise ValueError("need dist_nprocs >= 1 and 0 <= dist_procid < nprocs")
        if self.index_shards < 1:
            raise ValueError("index_shards must be >= 1")
        if self.shard_hosts:
            if self.index_shards < 2:
                raise ValueError("--shard-across-hosts needs --index-shards >= 2")
            if self.dist_nprocs > 1 and not self.dist_coordinator:
                raise ValueError(
                    "--shard-across-hosts with multiple processes needs "
                    "--dist-coordinator for the global jax.distributed runtime"
                )
            if self.topn > 1:
                raise ValueError(
                    "--shard-across-hosts does not support -n/--topn > 1 "
                    "(the mesh merge computes the single best); run topn "
                    "with the single-host sequential shard loop instead"
                )
        if self.index_shards > 1 and self.topn > 1 and self.devices > 1:
            # the sequential one-chip shard loop merges per-shard rank lists
            # (merge_sharded_topn); the (dp, ish) mesh step only computes the
            # single-best merge, so the combination of all three is rejected
            raise ValueError(
                "--index-shards with -n/--topn > 1 runs on a single device "
                "(sequential shard loop); drop --devices"
            )
