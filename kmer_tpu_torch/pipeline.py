"""Disk-to-table counting: the single-shot route of ``count_file``.

The counterpart of ``kmer_tpu/pipeline.py`` for files whose windows fit
one device buffer (up to ~150M window slots, e.g. 1M x 150 bp reads):

1. a producer thread parses the file (native C) and packs fixed-width
   2-bit rows, one ``[B, W/16 + 1]`` uint32 wire array per batch with the
   row lengths in the last column;
2. each batch uploads as it arrives, while the next one parses;
3. on the device each batch is unpacked, its k-windows extracted (and
   canonicalized), and written in place into one flat int64 key buffer;
4. one ``count_windows``: a sort, then the segment-count kernel.

The streaming-fold route of ``kmer_tpu`` (a 64-bit accumulator with
revert-and-replay, growth, spill and checkpoints) is not ported yet:
``count_file`` raises NotImplementedError where ``kmer_tpu`` would take
it, and never counts some other way.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from .codec import MAX_K
from .errors import InvalidKmerLengthError
from .native import device_unpack_rows, rows_packed
from .ops.count import CountTable, count_windows
from .ops.extract import canonicalize, extract_windows_batch
from .utils.logging import StatsCounters

# single-shot ceiling in window slots (the value of kmer_tpu/pipeline.py)
_SINGLE_SHOT_MAX = 150 * 1000 * 1000

_STREAMING_TODO = (
    "{why}: that needs the streaming-fold route (ROADMAP.md §1 item 5, "
    "ops/wide.py, and the rest of item 6, pipeline.count_batches_pipelined), "
    "which kmer_tpu_torch does not have yet"
)


def auto_width(lengths: np.ndarray, cap: int = 1024) -> int:
    """Row width for a read-length sample: the max length rounded up to a
    16-base word, capped (longer reads split exactly)."""
    mx = int(lengths.max()) if lengths.size else 16
    return max(32, min(cap, -(-mx // 16) * 16))


def auto_batch(width: int, k: int, target_windows: int = 1 << 26) -> int:
    """Reads per batch, sized so a batch carries ~64M window slots."""
    per = max(width - k + 1, 1)
    b = max(1, target_windows // per)
    return max(4096, min(1 << 20, 1 << int(b - 1).bit_length()))


def file_batch_feed(path: str, fmt: str, k: int, batch: int | None,
                    width: int | None, chunk_bytes: int | None = None,
                    ) -> tuple[Iterator, int, int, int]:
    """Fixed-shape feed for a FASTA/FASTQ file with auto batch/width.

    Returns (iterator of (words [B, W/16] uint32, lengths [B] uint16),
    batch, width, est_windows).  Width is sampled from the first ingest
    chunk when not given; longer reads split exactly, shorter ones pad.
    ``est_windows`` extrapolates the first chunk's window count to the
    whole file (0 when it holds no record): the routing signal.
    """
    from .io.ingest import DEFAULT_CHUNK_BYTES, iter_encoded_chunks

    cb = chunk_bytes or DEFAULT_CHUNK_BYTES
    est_windows = 0
    probe_bytes = min(cb, 16 << 20)
    fsize = os.path.getsize(path)
    for codes, offs in iter_encoded_chunks(path, fmt, probe_bytes):
        lens = np.diff(offs)
        if not width:
            width = auto_width(lens)
        wins = int(np.maximum(lens - (k - 1), 0).sum())
        est_windows = int(wins * max(fsize / min(probe_bytes, fsize), 1.0))
        break
    width = -(-(width or 256) // 16) * 16
    while width <= k - 1:
        width += 16
    if width > 0xFFFF:
        raise ValueError(
            f"width {width} exceeds the uint16 row-length bound (65535); "
            "long reads split exactly, so smaller widths lose nothing")
    if not batch:
        batch = auto_batch(width, k)
        # small files must not pay a full-size batch of padding
        need_rows = est_windows // max(width - k + 1, 1) + 1
        batch = min(batch, max(4096, 1 << int(need_rows).bit_length()))

    def gen():
        buf_w: list[np.ndarray] = []
        buf_l: list[np.ndarray] = []
        pending = 0
        for codes, offs in iter_encoded_chunks(path, fmt, cb):
            words, lens = rows_packed(codes, offs, width, k)
            buf_w.append(words)
            buf_l.append(lens)
            pending += words.shape[0]
            if pending >= batch:
                allw = np.concatenate(buf_w)
                alll = np.concatenate(buf_l)
                n_full = (pending // batch) * batch
                for s in range(0, n_full, batch):
                    yield allw[s: s + batch], alll[s: s + batch]
                buf_w = [allw[n_full:]]
                buf_l = [alll[n_full:]]
                pending -= n_full
        if pending:  # zero-length-padded fixed-shape tail
            allw = np.concatenate(buf_w)
            alll = np.concatenate(buf_l)
            for s in range(0, allw.shape[0], batch):
                w = allw[s: s + batch]
                ln = alll[s: s + batch]
                if w.shape[0] < batch:
                    pad = batch - w.shape[0]
                    w = np.concatenate(
                        [w, np.zeros((pad, w.shape[1]), np.uint32)])
                    ln = np.concatenate([ln, np.zeros(pad, ln.dtype)])
                yield w, ln

    return gen(), batch, width, est_windows


def _combine(words: np.ndarray, lengths) -> np.ndarray:
    """One wire array per batch: [B, W/16 + 1] uint32, the row lengths in
    the last column, so each batch is one upload."""
    b, nw = words.shape
    combo = np.empty((b, nw + 1), np.uint32)
    combo[:, :nw] = words
    combo[:, nw] = np.asarray(lengths).astype(np.uint32)
    return combo


class _Feeder(threading.Thread):
    """Producer: pulls (words, lengths) batches from the feed and queues
    their wire arrays, then None; an exception in the feed is queued for
    the consumer to raise.  The consumer calls ``stop`` when it is done,
    on every path, so the thread never stays blocked on a full queue."""

    def __init__(self, batches: Iterable, depth: int):
        super().__init__(daemon=True)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._batches = batches
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()
        try:  # unblock a producer stuck on a full queue
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def run(self):
        try:
            for words, lengths in self._batches:
                if not self._put(_combine(words, lengths)):
                    return
            self._put(None)
        except BaseException as e:  # raised again in the consumer
            self._put(e)


def _count_single_shot(feed, k: int, canonical: bool, batch: int,
                       width: int, device: torch.device,
                       stats: StatsCounters | None = None) -> CountTable:
    """Upload packed batches as they arrive (overlapping the parse), place
    each batch's windows into one flat key buffer, then count once."""
    spb = batch * (width - k + 1)
    ceiling = int(_SINGLE_SHOT_MAX * 1.3)  # routing estimate headroom
    wires = []
    feeder = _Feeder(feed, depth=3)
    feeder.start()
    try:
        while (item := feeder.q.get()) is not None:
            if isinstance(item, BaseException):
                raise item
            if (len(wires) + 1) * spb > ceiling:
                raise NotImplementedError(_STREAMING_TODO.format(
                    why=f"the file holds more than {ceiling} window slots"))
            # uint32 travels as int32 bits; widened on the device
            wires.append(torch.from_numpy(item.view(np.int32)).to(device))
            if stats is not None:
                ls = item[:, -1].astype(np.int64)
                stats.record_batch(int((ls > 0).sum()), int(ls.sum()),
                                   int(np.maximum(ls - (k - 1), 0).sum()), 0)
    finally:
        feeder.stop()
    if not wires:
        raise ValueError("empty batch stream")
    keys = torch.empty(len(wires) * spb, dtype=torch.int64, device=device)
    valid = torch.empty(len(wires) * spb, dtype=torch.bool, device=device)
    for i, wire in enumerate(wires):
        wire = wire.to(torch.int64) & 0xFFFFFFFF
        codes = device_unpack_rows(wire[:, :-1], width)
        wins, ok = extract_windows_batch(codes, wire[:, -1], k)
        if canonical:
            wins = canonicalize(wins, k)
        keys[i * spb: (i + 1) * spb] = wins.reshape(-1)
        valid[i * spb: (i + 1) * spb] = ok.reshape(-1)
    del wires
    return count_windows(keys, valid, k)


def count_file(
    path: str,
    fmt: str,
    k: int,
    canonical: bool = False,
    batch: int | None = None,
    width: int | None = None,
    chunk_bytes: int | None = None,
    max_capacity: int | None = None,
    spill_dir: str | None = None,
    stats: StatsCounters | None = None,
    ckpt_path: str | None = None,
    *,
    device: str | torch.device,
) -> CountTable:
    """Count a FASTA/FASTQ file end to end on ``device``; returns a
    CountTable on that device.

    Only the single-shot route is ported.  Where ``kmer_tpu.pipeline.
    count_file`` would take the streaming fold (a file with more than
    ~150M window slots, or a checkpoint, spill directory or device slot
    budget), this raises NotImplementedError.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} was asked for, but torch.cuda.is_available() "
            "is False")
    if not 1 <= k <= MAX_K:
        raise InvalidKmerLengthError()
    for flag, value in (("a checkpoint path", ckpt_path),
                        ("a spill directory", spill_dir),
                        ("a device slot budget", max_capacity)):
        if value:
            raise NotImplementedError(
                _STREAMING_TODO.format(why=f"{flag} was given"))
    feed, batch, width, est_windows = file_batch_feed(
        path, fmt, k, batch, width, chunk_bytes)
    if (est_windows * 1.1 > _SINGLE_SHOT_MAX
            or batch * (width - k + 1) > _SINGLE_SHOT_MAX):
        raise NotImplementedError(_STREAMING_TODO.format(
            why=f"the file routes to the streaming fold (about {est_windows} "
                f"windows, {batch} x {width - k + 1} slots per batch)"))
    return _count_single_shot(feed, k, canonical, batch, width, device, stats)
