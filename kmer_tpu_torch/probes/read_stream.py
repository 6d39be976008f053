"""``count_read_stream`` split up: ``scripts/probe_r5a.py`` on the port.

The workload is the script's: the 313 MB FASTQ of ``count_phases``
(1M x 150 bp reads, k = 21 canonical, 4,999,967 groups), batches of
262,144 reads, chunks of 64 MiB, and 2^22 starting slots.

``kmer_tpu.cli._reads_file_batches`` has no counterpart (every file path
of the port feeds the packed wire), so the feed here builds the
``(codes [B, L], lengths [B])`` batches that ``streaming.count_read_stream``
takes from ``native.fastq_encode``'s codes and offsets, chunk by chunk
(``io.ingest.iter_encoded_chunks``), each batch padded to its longest
read.  Each phase is timed alone on the last one's outputs:

* ``feed``: those batches;
* ``pack``: ``streaming._batch_wire`` (2-bit words and the length column);
* ``upload``: ``pipeline._upload`` of every wire;
* ``count``: ``wire_keys`` + ``count_windows`` a batch;
* ``merge``: ``WideAccumulator.add`` of every table, its growth included;
* ``shipped_e2e``: ``count_read_stream`` over a fresh feed, end to end;
* ``fast_e2e``: the script's pipelined prototype.  A producer thread packs
  (the engine's ``pipeline._Feeder``) while the main thread uploads and
  folds each batch through ``wire_keys`` and ``fold_windows_into_wide``
  into 2^23 slots.  Torch compiles nothing per shape, so the tail batch is
  not padded to one shape as the script's was.

Check: the two end-to-end tables are equal row for row, and hold
4,999,967 groups; the feed holds the file's 1,000,000 reads and
130,000,000 windows, the packed and the uploaded wires carry the feed's
bases in their length column, and the batch tables' totals add up to the
windows.  ``small`` counts 1,024 reads in batches of 256 and
chunks of 64 KiB, from 2^12 slots (2^18 for the fold).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io.ingest import iter_encoded_chunks
from ..kernels.wire_keys import wire_keys
from ..ops.count import count_windows
from ..ops.wide import WideAccumulator, WideCounts, fold_windows_into_wide
from ..pipeline import _Feeder, _upload
from ..streaming import _batch_wire, count_read_stream
from .common import PhaseRecord, card_of, table_digest, wall, workspace
from .count_phases import expected, holds, ingest_fastq, n_reads

K = 21
BATCH, CHUNK = 262_144, 64 << 20
SLOTS, FOLD_SLOTS = 1 << 22, 1 << 23
SITE = "scripts/probe_r5a.py"


def read_batches(path: str, batch: int, chunk_bytes: int):
    """(codes [B, L] uint8, lengths [B] int32) batches of the file's reads
    in file order, each padded with zeros to its longest read; the last
    one holds what is left."""
    rows: list[np.ndarray] = []
    lens: list[np.ndarray] = []
    pending = 0

    def take(n):
        nonlocal rows, lens, pending
        width = max(r.shape[1] for r in rows)
        codes = np.zeros((pending, width), np.uint8)
        at = 0
        for r in rows:
            codes[at: at + r.shape[0], : r.shape[1]] = r
            at += r.shape[0]
        ln = np.concatenate(lens)
        rows, lens, pending = [codes[n:]], [ln[n:]], pending - n
        return codes[:n], ln[:n]

    for codes, offs in iter_encoded_chunks(path, "fastq", chunk_bytes):
        ln = np.diff(offs).astype(np.int32)
        width = max(int(ln.max()), 1)
        idx = offs[:-1, None] + np.arange(width)[None, :]
        r = codes[np.minimum(idx, codes.size - 1)]
        r[np.arange(width)[None, :] >= ln[:, None]] = 0
        rows.append(r)
        lens.append(ln)
        pending += ln.size
        while pending >= batch:
            yield take(batch)
    if pending:
        yield take(pending)


def fast_e2e(path, batch, chunk_bytes, slots, device) -> WideCounts:
    """The pipelined prototype: ``pipeline._Feeder`` packs on its thread;
    here each wire is uploaded and folded into one accumulator."""
    acc = WideCounts.empty(slots, device)
    feeder = _Feeder(read_batches(path, batch, chunk_bytes), depth=4)
    feeder.start()
    try:
        while (item := feeder.q.get()) is not None:
            if isinstance(item, BaseException):
                raise item
            wire = item[1]
            keys, valid = wire_keys(_upload(wire, device),
                                    16 * (wire.shape[1] - 1), K, True)
            acc = fold_windows_into_wide(acc, keys, valid, K)
    finally:
        feeder.stop()
    return acc


def run(device: torch.device, small: bool = False, workdir=None):
    """Yields one record a phase, then the two end-to-end records."""
    card = card_of(device)
    want = expected(small)
    batch, chunk = (256, 64 << 10) if small else (BATCH, CHUNK)
    slots, fold_slots = (1 << 12, 1 << 18) if small else (SLOTS, FOLD_SLOTS)

    def record(name, seconds, correct=True, detail=None, tables=None):
        return PhaseRecord(name, "read_stream", SITE, str(device), correct,
                           seconds, detail, tables, card=card)

    with workspace(workdir) as d:
        path = ingest_fastq(d, small)
        size = os.path.getsize(path)
        batches, s = wall(lambda: list(read_batches(path, batch, chunk)),
                          device)
        lens = np.concatenate([ln.astype(np.int64) for _, ln in batches])
        n_windows = int(np.maximum(lens - (K - 1), 0).sum())
        bases = int(lens.sum())
        yield record("feed", {"feed": s},
                     lens.size == n_reads(small) and n_windows == want[
                         "total"], {
                         "file_GB": round(size / 1e9, 3),
                         "n_batches": len(batches), "reads": int(lens.size),
                         "n_windows": n_windows,
                         "batch_shapes": sorted({c.shape
                                                 for c, _ in batches})})
        wires, s = wall(lambda: [_batch_wire(c, ln, K) for c, ln in batches],
                        device)
        del batches
        mb = sum(w.nbytes for w, _ in wires) / 1e6
        packed = sum(int(w[:, -1].astype(np.int64).sum()) for w, _ in wires)
        yield record("pack", {"pack": s}, packed == bases,
                     {"packed_MB": round(mb, 1)})
        dev, s = wall(lambda: [(_upload(w, device), width)
                               for w, width in wires], device)
        del wires
        uploaded = sum(int(w[:, -1].sum()) for w, _ in dev)
        yield record("upload", {"upload": s}, uploaded == bases,
                     {"MB/s": round(mb / s, 1)})
        tables, s = wall(lambda: [
            count_windows(*wire_keys(w, width, K, True), K)
            for w, width in dev], device)
        del dev
        counted = sum(int(t.counts.sum()) for t in tables)
        yield record("count", {"count": s}, counted == n_windows,
                     {"counted": counted})

        def merge():
            acc = WideAccumulator(slots, device=device)
            for t in tables:
                acc.add(t)
            return acc.result(), acc.capacity

        (merged, cap), s = wall(merge, device)
        del tables
        merged = table_digest(merged)
        yield record("merge", {"merge": s}, holds(merged, want),
                     {"slots": f"{slots} -> {cap}"}, {"merge": merged})

        shipped, s = wall(lambda: count_read_stream(
            read_batches(path, batch, chunk), K, canonical=True,
            capacity=slots, device=device), device)
        shipped = table_digest(shipped)
        yield record("shipped_e2e", {"e2e": s},
                     holds(shipped, want) and shipped == merged,
                     {"Mkmers/s": round(n_windows / s / 1e6, 2)},
                     {"shipped_e2e": shipped})
        fast, s = wall(lambda: fast_e2e(path, batch, chunk, fold_slots,
                                        device), device)
        fits = fast.n_unique <= fold_slots
        fast = table_digest(fast)
        yield record("fast_e2e", {"e2e": s}, fits and fast == shipped,
                     {"Mkmers/s": round(n_windows / s / 1e6, 2),
                      "slots": fold_slots, "fast_exact_vs_shipped":
                      fast == shipped}, {"fast_e2e": fast})
