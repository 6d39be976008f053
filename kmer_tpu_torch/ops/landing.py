"""A table's live rows to the host: select, land, split.

The one helper behind ``WideCounts.trim``/``to_numpy`` and
``CountTable.trim``/``to_numpy``.

* **Select.**  A host table whose slots are all live is its own trim
  (path ``host``).  A table whose live rows are exactly its first ``n``
  slots (a compacted ``WideCounts``: ``n = min(n_unique, capacity)``) is
  cut with slices, after a check on the device and one synchronize (path
  ``slice``): no gather and no widened lane.  Any other table selects its rows with a mask (``mask``).
  Either way the rows keep their slot order.
* **Land.**  The selected columns land back to back in one new host
  allocation, each at an 8-byte boundary: 20 B a row for a ``WideCounts``
  (int64 key, int32 length, int64 count), 16 for a ``CountTable``.  Off
  a card they are copied there directly.  From a card they pass through
  a fixed ring of ``SLOTS`` pinned staging chunks of ``CHUNK_BYTES``,
  allocated once per process and never handed to a caller, so the copy
  runs at the pinned rate while pinned memory stays bounded by the ring:
  the device's copy of one chunk overlaps the host's copy of the last.
* **Split.**  ``split`` writes ``kmer_tpu``'s 32-bit lanes into one new
  ``[lanes, n]`` uint32 buffer, one strided copy a lane from the 32-bit
  halves of the int64 columns, over row blocks on a few threads (NumPy's
  copies release the interpreter lock).

``trims()`` reads the trims by path and the bytes landed through the
ring since the process started, as ``kernels.launches()`` reads the
kernels' launches.
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
import sys
import threading

import numpy as np
import torch

from ..utils.profiling import span

CHUNK_BYTES = 64 << 20  # one pinned staging chunk of the ring
SLOTS = 2  # chunks in the ring: one in the device's copy, one in the host's
SPLIT_ROWS = 1 << 20  # rows a split task copies, every lane of them
SPLIT_THREADS = min(8, os.cpu_count() or 1)

# the 32-bit half of an int64 that holds its high bits, in a uint32 view
_HIGH = 1 if sys.byteorder == "little" else 0

_ring_lock = threading.Lock()
_counts_lock = threading.Lock()
_ring: torch.Tensor | None = None
_counts = {"slice": 0, "mask": 0, "host": 0, "ring_bytes": 0}


def trims() -> dict[str, int]:
    """Trims by path (``slice``, ``mask``, ``host``) and the bytes landed
    through the ring (``ring_bytes``) in this process so far."""
    with _counts_lock:
        return dict(_counts)


def zero_trims() -> None:
    with _counts_lock:
        for key in _counts:
            _counts[key] = 0


def _count(key: str, n: int = 1) -> None:
    with _counts_lock:
        _counts[key] += n


def ring() -> torch.Tensor:
    """The process's staging ring, ``[SLOTS, CHUNK_BYTES]`` uint8 host
    memory, pinned where a card can copy into it; made at its first use.
    Only ``land_through_ring`` uses it, holding ``_ring_lock``."""
    global _ring
    if _ring is None:
        _ring = torch.empty((SLOTS, CHUNK_BYTES), dtype=torch.uint8,
                            pin_memory=torch.cuda.is_available())
    return _ring


def trim_rows(keys: torch.Tensor, length: torch.Tensor, counts: torch.Tensor,
              front: int | None = None
              ) -> tuple[str, tuple[torch.Tensor, ...]]:
    """(path, host columns) of the rows with ``counts > 0``, in slot
    order.  ``front`` is the number of leading slots that should hold
    every live row: the ``slice`` path is taken where they do.  On the
    ``host`` path the columns are the table's own tensors."""
    with span("trim.select"):
        path, cols = _select(keys, length, counts, front)
    _count(path)
    if path == "host":
        return path, cols
    nbytes = sum(c.numel() * c.element_size() for c in cols)
    with span("trim.copy", nbytes):
        if counts.device.type == "cpu":
            return path, land(cols)
        return path, land_through_ring(cols)


def _select(keys, length, counts, front):
    live = None
    if counts.device.type == "cpu":
        live = counts > 0
        if bool(live.all()):
            return "host", (keys, length, counts)
    if front is not None:
        n = min(front, counts.numel())
        if live is not None:
            prefix = live[:n].all() & ~live[n:].any()
        else:
            prefix = (counts[:n] > 0).all() & (counts[n:] <= 0).all()
        if bool(prefix):
            return "slice", (keys[:n], length[:n], counts[:n])
    if live is None:
        live = counts > 0
    idx = torch.nonzero(live).squeeze(1)
    return "mask", (keys[idx], length[idx], counts[idx])


def land_through_ring(cols) -> tuple[torch.Tensor, ...]:
    """``land`` through the process's ring, which it holds meanwhile;
    counts the bytes landed."""
    with _ring_lock:
        outs = land(cols, ring())
    _count("ring_bytes", sum(o.numel() * o.element_size() for o in outs))
    return outs


def land(cols, staging: torch.Tensor | None = None) -> tuple[torch.Tensor,
                                                             ...]:
    """``cols`` (1-D tensors on one device) copied back to back into one
    new host allocation, each at an 8-byte boundary; returns a host view
    of it for each column, in order.  With ``staging`` (``[slots, chunk]``
    uint8 host memory) the bytes pass through it in chunks
    (``copy_through``)."""
    cols = [c.contiguous() for c in cols]
    sizes = [c.numel() * c.element_size() for c in cols]
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total)
        total += -(-size // 8) * 8
    buf = torch.empty(total, dtype=torch.uint8)
    outs = tuple(buf[o: o + size].view(c.dtype)
                 for c, o, size in zip(cols, offsets, sizes))
    if staging is None:
        for out, c in zip(outs, cols):
            out.copy_(c)
    else:
        copy_through([(c.view(torch.uint8), out.view(torch.uint8))
                      for c, out in zip(cols, outs)], staging)
    return outs


def copy_through(pairs, staging: torch.Tensor) -> None:
    """Copies each (src, dst) pair of 1-D uint8 tensors, ``src`` on any
    device and ``dst`` on the host, through the rows of ``staging`` in
    turn.  A chunk's copy into its row is queued before the chunk ahead
    of it leaves its own, so from a card the device copies one chunk
    while the host copies the last out; a row is reused only after the
    host has copied its chunk out."""
    slots, size = staging.shape
    inflight: collections.deque = collections.deque()
    j = 0
    for src, dst in pairs:
        for a in range(0, src.numel(), size):
            b = min(a + size, src.numel())
            if len(inflight) == slots:
                _leave(*inflight.popleft())
            stage = staging[j % slots, : b - a]
            stage.copy_(src[a:b], non_blocking=True)
            done = None
            if src.is_cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(src.device))
            inflight.append((done, stage, dst[a:b]))
            j += 1
    while inflight:
        _leave(*inflight.popleft())


def _leave(done, stage, dst) -> None:
    if done is not None:
        done.synchronize()
    dst.copy_(stage)


def halves(a: np.ndarray, dtype) -> tuple[np.ndarray, np.ndarray]:
    """(high, low) 32-bit halves of a contiguous int64 array, as strided
    views of ``dtype``."""
    w = a.view(dtype)
    return w[_HIGH::2], w[1 - _HIGH::2]


def host_array(t: torch.Tensor, dtype) -> np.ndarray:
    """A table's column as a contiguous host array of ``dtype`` (a view
    where it already is one)."""
    return np.ascontiguousarray(t.cpu().numpy(), dtype)


def split(sources) -> tuple[np.ndarray, ...]:
    """Each source (1-D arrays of 4-byte items, strided views allowed, of
    one length n) copied into its row of one new ``[len(sources), n]``
    uint32 buffer; returns the rows, each viewed as its source's dtype.
    Blocks of ``SPLIT_ROWS`` rows, every lane of a block at once, run on
    up to ``SPLIT_THREADS`` threads."""
    n = len(sources[0])
    out = np.empty((len(sources), n), np.uint32)
    rows = tuple(out[i].view(s.dtype) for i, s in enumerate(sources))

    def part(a: int) -> None:
        b = min(a + SPLIT_ROWS, n)
        for dst, src in zip(rows, sources):
            np.copyto(dst[a:b], src[a:b])

    starts = range(0, n, SPLIT_ROWS)
    if len(starts) <= 1:
        for a in starts:
            part(a)
    else:
        with concurrent.futures.ThreadPoolExecutor(
                min(SPLIT_THREADS, len(starts))) as pool:
            list(pool.map(part, starts))  # raises what a task raised
    return rows
