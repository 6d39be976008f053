"""Count-table and index snapshots in ``kmer_tpu``'s npz layout, so a
file saved by either package loads in the other, and the checkpointed
shard count ``ResumableCount`` (counterpart of
``kmer_tpu/utils/checkpoint.py``).

Table layout: ``hi``/``lo`` uint32, ``length`` int32, ``counts`` int64 of
the live groups.  Index layout: ``KmerIndex``'s ``sorted_keys`` uint64,
``sorted_lens`` int32 and ``row_ids`` int64.  Both carry ``meta``, a JSON
string with ``"version": 1``.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from ..device import resolve_device
from ..index import KmerIndex
from ..ops.count import CountTable

_FORMAT_VERSION = 1


def atomic_savez(path: str, compress: bool = True, **arrays) -> None:
    """np.savez[_compressed] with crash-safe replace semantics: write a
    temp file in the same directory, fsync it and the directory entry,
    then os.replace, so a crash mid-write never truncates an existing
    snapshot."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            (np.savez_compressed if compress else np.savez)(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_table(table: CountTable, path: str, meta: dict | None = None) -> None:
    """Snapshot a count table's live groups + metadata to an .npz file."""
    hi, lo, length, counts = table.trim().to_numpy()
    atomic_savez(
        path,
        hi=hi,
        lo=lo,
        length=length,
        counts=counts.astype(np.int64),
        meta=json.dumps({"version": _FORMAT_VERSION, **(meta or {})}),
    )


def load_table(path: str) -> tuple[CountTable, dict]:
    """(host CountTable, meta) from a snapshot written by either package."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        table = CountTable.from_numpy(z["hi"], z["lo"], z["length"],
                                      z["counts"].astype(np.int32))
    return table, meta


def save_index(index: KmerIndex, path: str, meta: dict | None = None) -> None:
    atomic_savez(
        path,
        sorted_keys=index.sorted_keys,
        sorted_lens=index.sorted_lens,
        row_ids=index.row_ids,
        meta=json.dumps({"version": _FORMAT_VERSION, **(meta or {})}),
    )


def load_index(path: str) -> tuple[KmerIndex, dict]:
    """(KmerIndex, meta) from an index file written by either package."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        idx = KmerIndex(sorted_keys=z["sorted_keys"],
                        sorted_lens=z["sorted_lens"], row_ids=z["row_ids"])
    return idx, meta


class ResumableCount:
    """Checkpointed streaming count over an ordered list of input shards.

    Progress is (shards_done, the accumulated table).  On restart the
    completed shards are skipped and counting resumes from the snapshot;
    merges are associative, so the result is exact.  Counts accumulate
    in the 64-bit ``WideAccumulator`` on ``device``.  Snapshots are
    ``save_wide`` files with ``shards_done`` in their meta, the layout
    ``kmer_tpu``'s ``ResumableCount`` writes, so either package resumes
    the other's.
    """

    def __init__(self, ckpt_path: str, capacity: int = 1 << 16, *,
                 device: str | torch.device):
        from ..ops.wide import WideAccumulator

        self.ckpt_path = ckpt_path
        self._acc = WideAccumulator(capacity, device=resolve_device(device))
        self.shards_done = 0
        if os.path.exists(ckpt_path):
            from ..parallel.streaming import load_wide

            acc, meta = load_wide(ckpt_path)
            self._acc.seed(acc)
            self.shards_done = int(meta.get("shards_done", 0))

    @property
    def table(self):
        """The accumulated WideCounts so far (None before any update)."""
        return None if self._acc.empty else self._acc.result()

    def should_process(self, shard_idx: int) -> bool:
        return shard_idx >= self.shards_done

    def update(self, shard_idx: int, shard_table: CountTable) -> None:
        self._acc.add(shard_table)
        self.shards_done = shard_idx + 1

    def checkpoint(self) -> None:
        if not self._acc.empty:
            from ..parallel.streaming import save_wide

            save_wide(self._acc.result(), self.ckpt_path,
                      {"shards_done": self.shards_done})
