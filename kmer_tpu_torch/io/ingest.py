"""Out-of-core file ingestion: record-aligned byte windows of a FASTA or
FASTQ file (plain or ``.gz``), each parsed standalone by the native
encoders.  The counterpart of ``kmer_tpu/io/ingest.py``.

Memory bound: one chunk plus one carried partial record.  A record larger
than the chunk budget grows the carry until it completes.
"""

from __future__ import annotations

import gzip
from typing import Iterator

import numpy as np

from ..native import (N_POLICIES, contigs_encode, fasta_encode, fastq_encode,
                      record_boundary)
from ..utils.profiling import span

DEFAULT_CHUNK_BYTES = 256 << 20

# search this far back from a chunk's end for a record boundary before
# doubling; covers any realistic read length in one probe
_TAIL_WINDOW = 1 << 20


def _open_stream(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


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
