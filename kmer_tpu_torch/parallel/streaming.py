"""Wide-accumulator snapshots and overlapped checkpoint writes.

The counterpart of the single-device parts of
``kmer_tpu/parallel/streaming.py``: ``save_wide``/``load_wide`` write and
read the same npz layout, so a table or checkpoint saved by one package
loads in the other, and ``AsyncCheckpointer`` overlaps a write with the
count.  The sharded stream waits for the multi-device port.

Layout (format v2): the live rows' ``hi``/``lo`` uint32, ``length``
int32, ``counts_hi`` int32 and ``counts_lo`` uint32 (the 64-bit count
split), ``live_per_shard`` int64 [shards], ``shard_cap``, ``n_unique``
and ``meta``, a JSON string with ``"version": 2``.  Each shard's live
rows come back at the front of that shard.  Format v1 files (full-capacity
lanes) are read too.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np

from ..ops.count import SENTINEL, SENTINEL_LEN
from ..ops.wide import WideCounts

_CKPT_VERSION = 2


def save_wide(acc: WideCounts, path: str, meta: dict | None = None) -> None:
    """Snapshot a wide accumulator's live rows (one shard) to npz,
    atomically."""
    from ..utils.checkpoint import atomic_savez

    hi, lo, length, counts_hi, counts_lo = acc.trim().to_numpy()
    atomic_savez(
        path,
        hi=hi, lo=lo, length=length,
        counts_hi=counts_hi, counts_lo=counts_lo,
        live_per_shard=np.asarray([hi.size], np.int64),
        shard_cap=np.int64(acc.capacity),
        n_unique=np.int64(acc.n_unique),
        meta=json.dumps({"version": _CKPT_VERSION, **(meta or {})}),
    )


def load_wide(path: str) -> tuple[WideCounts, dict]:
    """(host WideCounts, meta) from a snapshot written by either package."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        version = int(meta.get("version", 1))
        if version > _CKPT_VERSION:
            raise ValueError(
                f"checkpoint {path} is format v{version}; this build "
                f"reads up to v{_CKPT_VERSION}"
            )
        if version >= 2 and "live_per_shard" not in z.files:
            raise ValueError(
                f"checkpoint {path} stamps v{version} but lacks the "
                "compact live_per_shard layout that version requires"
            )
        lanes = [z[name] for name in
                 ("hi", "lo", "length", "counts_hi", "counts_lo")]
        if "live_per_shard" in z.files:  # compact: pad each shard back
            lps = np.asarray(z["live_per_shard"], np.int64)
            shard_cap = int(z["shard_cap"])
            fills = (SENTINEL, SENTINEL, SENTINEL_LEN, 0, 0)
            out = []
            for src, fill in zip(lanes, fills):
                full = np.full((lps.size, shard_cap), fill, src.dtype)
                start = 0
                for p, n in enumerate(lps):
                    full[p, :n] = src[start: start + n]
                    start += n
                out.append(full.reshape(-1))
            lanes = out
        acc = WideCounts.from_numpy(*lanes, n_unique=int(z["n_unique"]))
    return acc, meta


class AsyncCheckpointer:
    """Overlapped checkpoint writes.

    ``submit`` hands the write's arguments to a daemon thread, which
    copies the accumulator to the host and writes it while the main loop
    keeps counting.  The accumulator functions return new tensors and
    never write into their inputs, so the reference passed is a
    consistent snapshot; the caller waits for the device work that made
    it before ``submit``.  One write is in flight at a time: a new submit
    joins the previous one.  A crash mid-write is safe: ``atomic_savez``
    replaces the file only with a complete, fsynced one.
    """

    def __init__(self, write_fn):
        self._write_fn = write_fn
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None
        self.wait_s = 0.0  # total time the main loop stalled on joins
        self.last_write_s = 0.0  # duration of the last completed write

    def _join(self) -> None:
        if self._thread is not None:
            t0 = time.perf_counter()
            self._thread.join()
            self.wait_s += time.perf_counter() - t0
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, *args, **kwargs) -> None:
        self._join()

        def work():
            t0 = time.perf_counter()
            try:
                self._write_fn(*args, **kwargs)
                self.last_write_s = time.perf_counter() - t0
            except BaseException as e:  # raised again at the next join
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Join the in-flight write and raise any error it had."""
        self._join()
