"""Out-of-core file ingestion: record-aligned byte windows of a FASTA or
FASTQ file (plain or ``.gz``), each parsed standalone by the native
encoders.  The counterpart of ``kmer_tpu/io/ingest.py``.

Memory bound: one chunk plus one carried partial record.  A record larger
than the chunk budget grows the carry until it completes.  The file
probe's sample (``probe_sample``) is bounded by its size alone: it never
reads on to a record's end.
"""

from __future__ import annotations

import gzip
import zlib
from typing import Iterator

import numpy as np

from ..native import (N_POLICIES, contigs_encode, fasta_encode, fastq_encode,
                      record_boundary)
from ..utils.profiling import span

DEFAULT_CHUNK_BYTES = 256 << 20

# search this far back from a chunk's end for a record boundary before
# doubling; covers any realistic read length in one probe
_TAIL_WINDOW = 1 << 20

# compressed bytes handed to the inflater at a time by probe_sample
_GZ_STEP = 1 << 20


def _open_stream(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _inflate_prefix(f, n: int) -> tuple[bytes, int]:
    """The first ``n`` inflated bytes (fewer at the end) of the gzip
    members read from the raw file ``f``, as ``gzip.open`` reads them
    (zero padding between members skipped), and the compressed bytes the
    inflater consumed to make them."""
    out: list[bytes] = []
    got = consumed = 0
    d = None
    buf = b""
    while got < n:
        if not buf:
            buf = f.read(_GZ_STEP)
            if not buf:
                if d is not None:
                    raise EOFError("Compressed file ended before the "
                                   "end-of-stream marker was reached")
                break
        if d is None:  # between members
            rest = buf.lstrip(b"\x00")
            consumed += len(buf) - len(rest)
            buf = rest
            if not buf:
                continue
            d = zlib.decompressobj(16 + zlib.MAX_WBITS)
        try:
            piece = d.decompress(buf, n - got)
        except zlib.error as e:
            raise gzip.BadGzipFile(str(e)) from e
        out.append(piece)
        got += len(piece)
        rest = d.unused_data if d.eof else d.unconsumed_tail
        consumed += len(buf) - len(rest)
        buf = rest
        if d.eof:
            d = None
    return b"".join(out), consumed


def _cut_near_end(data: bytes, fmt: str) -> int:
    """The cut ``iter_record_chunks`` makes in a step's data: the first
    record start in a tail window widened backwards from the end until one
    is found (``len(data)`` where there is none, or where the data is
    shorter than half a tail window)."""
    window = _TAIL_WINDOW
    while window < 2 * len(data):
        b = record_boundary(data, max(1, len(data) - window), fmt)
        if b < len(data):
            return b
        window *= 2
    return len(data)


def probe_sample(path: str, fmt: str, probe_bytes: int
                 ) -> tuple[bytes, int, bool]:
    """The file probe's sample of a file: (window, disk_bytes,
    cut_in_record).

    Reads at most ``probe_bytes`` of (inflated) input, and one byte more
    to see whether the file goes on.  Where the sample is the whole file,
    or holds a record boundary and is longer than half of
    ``_TAIL_WINDOW``, ``window`` is the first window
    ``iter_record_chunks(path, fmt, probe_bytes)`` yields, cut by the
    same search; a shorter sample of a longer file, which that loop reads
    on past before it searches, is cut at its first record's end.  Where
    the sample holds no boundary and the file goes on (one record longer
    than the sample), ``cut_in_record`` is set and ``window`` is the
    sample for FASTA (a record's prefix is a record) and, for FASTQ, the
    record's header and sequence line as far as the sample holds them,
    which stand for a quality line as long besides: nothing is read past
    the sample.  ``disk_bytes`` is the bytes on disk the window stands
    for: in a plain file its own length (with that quality line); in a
    ``.gz`` the compressed bytes consumed to inflate the sample, times the
    window's share of it.  The read, the search and the cut are one
    ``feed.read`` span with the bytes read.
    """
    if probe_bytes <= 0:
        raise ValueError("probe_bytes must be positive")
    with span("feed.read") as step, open(path, "rb") as f:
        if path.endswith(".gz"):
            data, used = _inflate_prefix(f, probe_bytes + 1)
        else:
            data = f.read(probe_bytes + 1)
            used = len(data)
        step.nbytes = len(data)
        more = len(data) > probe_bytes
        if more:
            data = data[:probe_bytes]
        cut = _cut_near_end(data, fmt)
        if more and cut == len(data) and 2 * len(data) <= _TAIL_WINDOW:
            # too short for iter_record_chunks to search: it reads on
            cut = record_boundary(data, 1, fmt)
        cut_in_record = more and not 0 < cut < len(data)
        quality = 0  # bytes on disk the window stands for besides its own
        if 0 < cut < len(data):
            window = data[:cut]
        elif cut_in_record and fmt == "fastq":
            head = data.find(b"\n") + 1
            end = data.find(b"\n", head)
            window = data[:end + 1] if end >= 0 else data
            quality = len(window) - head
        else:
            window = data
        disk = used * (len(window) + quality) // max(len(data) + more, 1)
    return window, disk, cut_in_record


def iter_record_chunks(
    path: str, fmt: str, chunk_bytes: int = DEFAULT_CHUNK_BYTES
) -> Iterator[bytes]:
    """Yield byte windows of ~chunk_bytes cut at record boundaries.

    Every window starts at a validated record start and ends immediately
    before one, so the concatenation of all windows' records equals the
    whole file's.  Each step (its reads, the join with the carry, the
    boundary search) is a ``feed.read`` span with the bytes it read.
    """
    if chunk_bytes <= 0:
        raise ValueError("chunk_bytes must be positive")
    carry = b""
    with _open_stream(path) as f:
        while True:
            with span("feed.read") as step:
                # read in bounded increments: file.read(n) preallocates
                # ~n bytes
                parts = []
                got = 0
                while got < chunk_bytes:
                    b = f.read(min(64 << 20, chunk_bytes - got))
                    if not b:
                        break
                    parts.append(b)
                    got += len(b)
                step.nbytes = got
                if not parts:
                    break
                block = parts[0] if len(parts) == 1 else b"".join(parts)
                data = (carry + block) if carry else block
                # find a boundary near the end; widen backwards while the
                # tail window is mid-record
                window = _TAIL_WINDOW
                cut = len(data)
                while window < 2 * len(data):
                    b = record_boundary(data, max(1, len(data) - window), fmt)
                    if b < len(data):
                        cut = b
                        break
                    window *= 2
                if cut == len(data) or cut == 0:
                    carry = data  # no internal boundary: read on
                    continue
                out, carry = data[:cut], data[cut:]
            yield out
    if carry:
        yield carry


def iter_encoded_chunks(
    path: str, fmt: str, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    n_policy: str = "skip", stats=None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (codes stream, per-read offsets) per bounded chunk; each
    parse is a ``feed.parse`` span with the bytes parsed.

    ``n_policy`` "skip" drops non-ACGT bases and joins their flanks;
    "break" ends a contig at each run of them, so each offset pair is a
    contig (``native.contigs_encode``), and adds the parse's ``breaks``
    and ``break_bases`` into ``stats`` (a ``StatsCounters``), if given.
    Chunks are cut at record boundaries, so a contig or a run never
    straddles two of them."""
    if n_policy not in N_POLICIES:
        raise ValueError(f"n_policy {n_policy!r} is not one of {N_POLICIES}")
    enc = fastq_encode if fmt == "fastq" else fasta_encode
    for window in iter_record_chunks(path, fmt, chunk_bytes):
        with span("feed.parse", len(window)):
            if n_policy == "skip":
                codes, offs = enc(window)
            else:
                codes, offs, breaks, gaps = contigs_encode(window, fmt)
                if stats is not None:
                    stats.breaks += breaks
                    stats.break_bases += gaps
        if offs.size > 1:
            yield codes, offs


def encode_window(window: bytes, fmt: str, n_policy: str = "skip"
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(codes stream, per-read offsets) of one window, parsed as
    ``iter_encoded_chunks`` parses each of its windows (a ``feed.parse``
    span with the bytes parsed); "break" counts nothing here."""
    if n_policy not in N_POLICIES:
        raise ValueError(f"n_policy {n_policy!r} is not one of {N_POLICIES}")
    with span("feed.parse", len(window)):
        if n_policy == "skip":
            enc = fastq_encode if fmt == "fastq" else fasta_encode
            return enc(window)
        codes, offs, _, _ = contigs_encode(window, fmt)
        return codes, offs
