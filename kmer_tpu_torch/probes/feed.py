"""The host feed's rates: ``scripts/probe_feed.py`` on the port.

The workload is the script's: a FASTQ of 3,300,000 uniform 150 bp reads,
drawn from ``default_rng(0)`` in blocks of 100,000 and numbered ``@r0``
on, written once with numpy (``runs.ingest.fastq_block``, byte for byte
the script's per-read loop): 1,035,088,890 bytes.  The script's
docstring asks for ">= 1 GB"; its rewrite test (``< 1 << 30`` bytes)
lies above its own file's size.

* (a) the native parse + encode (``native.fastq_encode``, the port's
  build of the same C parser) over the file's bytes, in GB/s, with the
  parser's threads (``native._parse_threads()``);
* (b) the feed at batch 4,096 and 65,536.  ``kmer_tpu.cli``'s
  ``_reads_file_batches`` has no counterpart: every file path of the
  port feeds the packed wire, ``pipeline.file_batch_feed`` (parse,
  ``kn_rows_packed``, batches of one shape).  Each prints GB/s of file
  bytes, M bases/s and the reads.

Check: both feeds give every read and base (3,300,000 and 495,000,000).
Host work alone: no time here is a device time.  ``small`` writes 3,300
reads.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import native
from ..pipeline import file_batch_feed
from ..runs.ingest import fastq_block
from .common import PhaseRecord, card_of, wall, workspace

N_READS, READ_LEN, K = 3_300_000, 150, 21
BLOCK = 100_000  # reads drawn (and written) at a time
BATCHES = (4096, 65536)
SITE = "scripts/probe_feed.py"


def write_reads(path: str, n_reads: int) -> int:
    """Write the script's file of ``n_reads`` uniform reads; returns its
    size."""
    rng = np.random.default_rng(0)
    letters = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb", buffering=1 << 22) as f:
        for s in range(0, n_reads, BLOCK):
            m = min(BLOCK, n_reads - s)
            f.write(fastq_block(letters[rng.integers(0, 4, (m, READ_LEN))],
                                s))
    return os.path.getsize(path)


def run(device: torch.device, small: bool = False, workdir=None):
    """Yields the parse record and one record a feed batch size."""
    n_reads = N_READS // 1000 if small else N_READS
    want = {"reads": n_reads, "bases": n_reads * READ_LEN}
    card = card_of(device)
    with workspace(workdir) as d:
        path = os.path.join(d, "feed.fastq")
        _, write_s = wall(lambda: write_reads(path, n_reads), device)
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            data = f.read()
        (codes, offs), parse_s = wall(lambda: native.fastq_encode(data),
                                      device)
        del data
        got = {"reads": int(offs.size - 1), "bases": int(codes.size)}
        yield PhaseRecord(
            "native parse+encode", "feed", SITE, str(device), got == want,
            {"write": write_s, "parse": parse_s},
            {"file_bytes": size, "GB/s": round(size / parse_s / 1e9, 3),
             **got, "parse_threads": native._parse_threads()}, card=card)
        del codes, offs
        for batch in BATCHES:
            def feed():
                it, b, width, _ = file_batch_feed(path, "fastq", K, batch,
                                                  None)
                n = nb = 0
                for words, lengths in it:
                    n += int((lengths > 0).sum())
                    nb += int(lengths.sum(dtype=np.int64))
                return {"reads": n, "bases": nb}, width

            (got, width), s = wall(feed, device)
            yield PhaseRecord(
                f"feed batch={batch}", "feed", SITE, str(device),
                got == want, {"feed": s},
                {"GB/s file bytes": round(size / s / 1e9, 3),
                 "M bases/s": round(got["bases"] / s / 1e6, 1), **got,
                 "width": width, "parse_threads": native._parse_threads(),
                 "route": "pipeline.file_batch_feed (the packed wire)"},
                card=card)
