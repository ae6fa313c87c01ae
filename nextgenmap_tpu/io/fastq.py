"""FASTQ/FASTA read streaming into fixed-shape padded batches.

Reference analog: ReadProvider (ref:src/ReadProvider.cpp) + kseq
(ref:src/kseq.h): streams reads, links mates, feeds worker threads.  Here the
provider yields struct-of-arrays batches with static shapes — `[B, L]` uint8
code matrices plus lengths — which is what the jitted device step consumes
(SURVEY.md §7 design stance: variable-length structures become fixed shapes
with caps + masks).

Mates are interleaved within a batch: for paired input, batch rows 2i / 2i+1
are mate1 / mate2 of pair i.  This keeps pair resolution a pure reshape on
device instead of a cross-batch join.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from nextgenmap_tpu.io.encode import PAD, encode_seq
from nextgenmap_tpu.io.fasta import _open_text


@dataclass
class ReadRecord:
    name: str
    codes: np.ndarray  # uint8 [len]
    qual: bytes | None  # phred+33 ASCII, None for FASTA


@dataclass
class ReadBatch:
    """Fixed-shape batch of reads. `n` real rows; rows >= n are padding."""

    codes: np.ndarray      # uint8 [B, L], PAD beyond each read's length
    lengths: np.ndarray    # int32 [B], 0 for padding rows
    names: list[str]       # len B ('' for padding rows)
    quals: list[bytes | None]
    n: int
    paired: bool = False   # rows 2i/2i+1 are mates

    @property
    def batch_size(self) -> int:
        return self.codes.shape[0]

    @property
    def read_len(self) -> int:
        return self.codes.shape[1]


def _iter_sam_reads(lines) -> Iterator[ReadRecord]:
    """Read records out of SAM text input (ref component 14's BAM/SAM input
    path): QNAME/SEQ/QUAL columns; secondary/supplementary records are
    skipped; reverse-flagged records are restored to original orientation.
    Mate order within a QNAME follows FLAG 0x40/0x80 so -p interleaving
    works on name-grouped SAM files.
    """
    from nextgenmap_tpu.io.encode import revcomp_codes

    for line in lines:
        if line.startswith(b"@"):
            continue
        f = line.rstrip(b"\n").split(b"\t")
        if len(f) < 11 or f[9] in (b"*", b""):
            continue
        flag = int(f[1])
        if flag & (0x100 | 0x800):  # secondary/supplementary: not a read
            continue
        codes = encode_seq(f[9])
        qual = None if f[10] == b"*" else bytes(f[10])
        if flag & 0x10:  # stored reverse-complemented; restore original
            codes = revcomp_codes(codes)
            qual = qual[::-1] if qual is not None else None
        name = f[0].decode("ascii")
        if flag & 0x1:
            name += "/1" if flag & 0x40 else "/2"
        yield ReadRecord(name, codes, qual)


def _looks_like_sam(first_line: bytes) -> bool:
    if first_line[:4] in (b"@HD\t", b"@SQ\t", b"@RG\t", b"@PG\t", b"@CO\t"):
        return True
    return first_line.count(b"\t") >= 10


def _is_bam_input(path: str) -> bool:
    if path.endswith(".bam"):
        return True
    import gzip

    try:
        with gzip.open(path, "rb") as f:
            return f.read(4) == b"BAM\x01"
    except OSError:
        return False


def _iter_bam_reads(path: str) -> Iterator[ReadRecord]:
    """BAM input (ref component 14's bamtools parser analog): decode records
    with io/bam.py's reader and reuse the SAM-record read extraction."""
    from nextgenmap_tpu.io.bam import read_bam

    _, _, recs = read_bam(path)
    yield from _iter_sam_reads("\t".join(r).encode() for r in recs)


def iter_reads(path: str) -> Iterator[ReadRecord]:
    """Stream FASTQ, FASTA, SAM, or BAM records (auto-detected, gz ok)."""
    if _is_bam_input(path):
        yield from _iter_bam_reads(path)
        return
    with _open_text(path) as f:
        first = f.peek(1)[:1] if hasattr(f, "peek") else b""
        if not first:
            line = f.readline()
            if not line:
                return
            first = line[:1]
            rest = itertools.chain([line], f)
        else:
            rest = f
        if path.endswith((".sam", ".sam.gz")):
            yield from _iter_sam_reads(rest)
            return
        if first == b"@":
            # '@' opens both FASTQ and SAM headers; peek one line to decide
            line = next(iter(rest), b"")
            if _looks_like_sam(line):
                yield from _iter_sam_reads(itertools.chain([line], rest))
                return
            rest = itertools.chain([line], rest)
        if first == b">":
            # FASTA reads
            name, chunks = None, []
            for line in rest:
                line = line.strip()
                if not line:
                    continue
                if line.startswith(b">"):
                    if name is not None:
                        yield ReadRecord(name, encode_seq(b"".join(chunks)), None)
                    name = line[1:].split()[0].decode("ascii")
                    chunks = []
                else:
                    chunks.append(line)
            if name is not None:
                yield ReadRecord(name, encode_seq(b"".join(chunks)), None)
        else:
            it = iter(rest)
            while True:
                try:
                    hdr = next(it).strip()
                except StopIteration:
                    return
                if not hdr:
                    continue
                seq = next(it).strip()
                next(it)  # '+'
                qual = next(it).strip()
                name = hdr[1:].split()[0].decode("ascii")
                yield ReadRecord(name, encode_seq(seq), bytes(qual))


def _strip_mate_suffix(name: str) -> str:
    if len(name) > 2 and name[-2] == "/" and name[-1] in "12":
        return name[:-2]
    return name


def _pack(records: list[ReadRecord], batch_size: int, read_len: int, paired: bool) -> ReadBatch:
    codes = np.full((batch_size, read_len), PAD, dtype=np.uint8)
    lengths = np.zeros(batch_size, dtype=np.int32)
    names: list[str] = [""] * batch_size
    quals: list[bytes | None] = [None] * batch_size
    for i, r in enumerate(records):
        L = min(len(r.codes), read_len)
        codes[i, :L] = r.codes[:L]
        lengths[i] = L
        names[i] = _strip_mate_suffix(r.name) if paired else r.name
        quals[i] = r.qual[:L] if r.qual is not None else None
    return ReadBatch(codes, lengths, names, quals, n=len(records), paired=paired)


def _window(it: Iterator[ReadRecord], skip: int, count: int) -> Iterator[ReadRecord]:
    """Skip the first `skip` reads; yield at most `count` (0 = unlimited).

    Backs --qry-start/--qry-count and checkpoint resume (SURVEY.md §5.4:
    resume = record the input offset per host, re-enter at a read boundary).
    """
    stop = None if count <= 0 else skip + count
    return itertools.islice(it, skip, stop)


def _batch_single_native(
    path: str, batch_size: int, read_len: int, skip: int, count: int
) -> Iterator[ReadBatch]:
    """Native-parser batching: C++ does the per-record char work
    (nextgenmap_tpu/native/ngmio.cpp, reference analog kseq.h)."""
    from nextgenmap_tpu import native

    CHUNK = 8 << 20
    emitted = 0
    codes = np.full((batch_size, read_len), PAD, np.uint8)
    lengths = np.zeros(batch_size, np.int32)
    names: list[str] = [""] * batch_size
    quals: list[bytes | None] = [None] * batch_size
    fill = 0

    with _open_text(path) as f:
        tail = b""
        eof = False
        while not eof or tail:
            chunk = f.read(CHUNK) if not eof else b""
            if not chunk:
                eof = True
            buf = tail + chunk
            if not buf:
                break
            n, c, ln, nm, ql, used = native.parse_reads(
                buf, eof, batch_size - fill, read_len
            )
            if n == 0 and used == 0 and eof:
                break
            tail = buf[used:]
            if (
                fill == 0 and skip == 0 and n == batch_size
                and not (count and emitted + n > count)
            ):
                # steady-state fast path: the parsed arrays ARE the batch
                yield ReadBatch(c, ln, nm, ql, n=n)
                emitted += n
                continue
            for i in range(n):
                if skip > 0:
                    skip -= 1
                    continue
                if count and emitted >= count:
                    tail = b""
                    eof = True
                    break
                codes[fill] = c[i]
                lengths[fill] = ln[i]
                names[fill] = nm[i]
                quals[fill] = ql[i]
                fill += 1
                emitted += 1
                if fill == batch_size:
                    yield ReadBatch(codes, lengths, names, quals, n=fill)
                    codes = np.full((batch_size, read_len), PAD, np.uint8)
                    lengths = np.zeros(batch_size, np.int32)
                    names = [""] * batch_size
                    quals = [None] * batch_size
                    fill = 0
    if fill:
        yield ReadBatch(codes, lengths, names, quals, n=fill)


def _is_sam_input(path: str) -> bool:
    if path.endswith((".sam", ".sam.gz")):
        return True
    try:
        with _open_text(path) as f:
            return _looks_like_sam(f.readline())
    except OSError:
        return False


def batch_single(
    path: str, batch_size: int, read_len: int, skip: int = 0, count: int = 0
) -> Iterator[ReadBatch]:
    """Single-end: pack reads into [B, L] batches (last one padded)."""
    from nextgenmap_tpu import native

    if native.lib() is not None and not _is_sam_input(path) and not _is_bam_input(path):
        yield from _batch_single_native(path, batch_size, read_len, skip, count)
        return
    buf: list[ReadRecord] = []
    for rec in _window(iter_reads(path), skip, count):
        buf.append(rec)
        if len(buf) == batch_size:
            yield _pack(buf, batch_size, read_len, paired=False)
            buf = []
    if buf:
        yield _pack(buf, batch_size, read_len, paired=False)


def _iter_reads_native(path: str, read_len: int) -> Iterator[ReadRecord]:
    """ReadRecord stream via the native chunk parser (no per-record Python
    readline/encode — the C parser fills [n, L] code arrays per chunk)."""
    from nextgenmap_tpu import native

    CHUNK = 8 << 20
    with _open_text(path) as f:
        tail = b""
        eof = False
        while not eof or tail:
            chunk = f.read(CHUNK) if not eof else b""
            if not chunk:
                eof = True
            buf = tail + chunk
            if not buf:
                break
            n, c, ln, nm, ql, used = native.parse_reads(
                buf, eof, 1 << 16, read_len
            )
            if n == 0 and used == 0 and eof:
                break
            tail = buf[used:]
            for i in range(n):
                # row views are copied by _pack before the next chunk reuses
                # the arrays (consumption is strictly streaming)
                yield ReadRecord(nm[i], c[i, : ln[i]], ql[i])


def _reads_for_pairing(path: str, read_len: int) -> Iterator[ReadRecord]:
    from nextgenmap_tpu import native

    if native.lib() is not None and not _is_sam_input(path) \
            and not _is_bam_input(path):
        return _iter_reads_native(path, read_len)
    return iter_reads(path)


def batch_paired(
    path1: str, path2: str | None, batch_size: int, read_len: int,
    skip: int = 0, count: int = 0,
) -> Iterator[ReadBatch]:
    """Paired-end from two files (-1/-2) or one interleaved file (-p).

    batch_size must be even; rows 2i/2i+1 hold the two mates of pair i.
    skip/count are in READS (must be even — enforced by the caller).
    Uses the native chunk parser per file when available (the Python
    per-record parse is much slower).
    """
    if batch_size % 2:
        raise ValueError("paired batch_size must be even")
    if path2 is not None:
        pairs = zip(_reads_for_pairing(path1, read_len),
                    _reads_for_pairing(path2, read_len), strict=True)
        flat: Iterator[ReadRecord] = itertools.chain.from_iterable(pairs)
    else:
        flat = _reads_for_pairing(path1, read_len)
    flat = _window(flat, skip, count)
    buf: list[ReadRecord] = []
    for rec in flat:
        buf.append(rec)
        if len(buf) == batch_size:
            yield _pack(buf, batch_size, read_len, paired=True)
            buf = []
    if buf:
        if len(buf) % 2:
            raise ValueError("odd number of reads in paired input")
        yield _pack(buf, batch_size, read_len, paired=True)


def peek_read_len(path: str, sample: int = 1000) -> int:
    """Max read length over the first `sample` reads (drives static shapes).

    Reference analog: ReadProvider's read-length stats that drive corridor
    sizing (SURVEY.md §2 component 14).
    """
    m = 0
    for rec in itertools.islice(iter_reads(path), sample):
        m = max(m, len(rec.codes))
    return m
