"""64-bit exact count accumulation: the wide accumulator and its merges.

The counterpart of ``kmer_tpu/ops/wide.py``.  A ``WideCounts`` is a
deduplicated (key, length, count) table of fixed capacity: live slots sit
at the front in ascending unsigned key order, and dead slots hold
``SENTINEL_KEY``, ``SENTINEL_LEN`` and a count of 0.  Counts are one
native int64 lane, so totals stay exact far past 2^31.

What the TPU version needed and the port leaves out: the int32 pair
arithmetic for 64-bit counts (``_pair_add``/``_pair_sub``/
``_pair_cumsum``), the k-tier sort-lane narrowing, and the blocked
compact (``_narrow_to_cap``) and tag-lane sort (``_compact_fit``) that
move live rows to the front.  Here a key is one int64 sorted as
``key ^ SIGN_FLIP``, and moving live rows to the front is a boolean-mask
stream compaction on ``counts > 0``.

Liveness is ``counts > 0`` everywhere, never ``key != SENTINEL_KEY``: an
all-``t`` 32-mer equals the sentinel key bit for bit.  Every function
returns new tensors and never writes into its inputs, so a reference to
an accumulator is a consistent snapshot (the checkpoint writer relies on
it).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..packed import SIGN_FLIP, PackedKmers, key_from_hi_lo
from ..utils.profiling import span
from . import landing
from .count import SENTINEL_KEY, SENTINEL_LEN, CountTable, count_windows


@dataclasses.dataclass(frozen=True)
class WideCounts:
    """Compacted (key, 64-bit count) table, ascending unsigned key order.

    keys: int64 [capacity]; length: int32 [capacity]; counts: int64
    [capacity]; n_unique: the number of distinct keys.  Slot i is live
    iff its count is > 0.  After a merge that overflowed, ``n_unique``
    exceeds ``capacity`` (the surplus, largest keys were dropped): that is
    the overflow signal.
    """

    keys: torch.Tensor
    length: torch.Tensor
    counts: torch.Tensor
    n_unique: int

    @property
    def capacity(self) -> int:
        return int(self.keys.numel())

    def counts64(self) -> np.ndarray:
        """Host-side exact counts (numpy int64), one per slot."""
        return self.counts.cpu().numpy().astype(np.int64)

    def trim(self) -> "WideCounts":
        """The live rows, in slot order, as a host table
        (``landing.trim_rows``): live rows at the front of the slots are
        cut as slices, and from a card they land through the pinned ring
        in one host allocation; a host table of live rows alone is not
        copied."""
        path, (keys, length, counts) = landing.trim_rows(
            self.keys, self.length, self.counts,
            front=min(self.n_unique, self.capacity))
        if path == "host":
            return dataclasses.replace(self, n_unique=self.capacity)
        return WideCounts(keys=keys, length=length, counts=counts,
                          n_unique=int(keys.numel()))

    def to_numpy(self) -> tuple[np.ndarray, ...]:
        """(hi uint32, lo uint32, length int32, counts_hi int32, counts_lo
        uint32): the lanes of a ``kmer_tpu`` WideCounts with these slots,
        rows of one new [5, n] buffer (``landing.split``)."""
        with span("to_numpy"):
            keys = landing.host_array(self.keys, np.int64)
            counts = landing.host_array(self.counts, np.int64)
            return landing.split((
                *landing.halves(keys, np.uint32),
                landing.host_array(self.length, np.int32),
                landing.halves(counts, np.int32)[0],
                landing.halves(counts, np.uint32)[1]))

    @classmethod
    def from_numpy(cls, hi, lo, length, counts_hi, counts_lo,
                   n_unique: int | None = None,
                   device: str | torch.device = "cpu") -> "WideCounts":
        """A table from a ``kmer_tpu`` WideCounts's five lanes, on
        ``device``; ``n_unique`` defaults to the number of live slots."""
        counts = (np.asarray(counts_hi, np.int64) << np.int64(32)) + \
            np.asarray(counts_lo, np.int64)
        if n_unique is None:
            n_unique = int((counts > 0).sum())
        return cls(
            keys=torch.tensor(key_from_hi_lo(hi, lo), device=device),
            length=torch.tensor(np.asarray(length, np.int32), device=device),
            counts=torch.tensor(counts, device=device),
            n_unique=int(n_unique),
        )

    def to(self, device: str | torch.device) -> "WideCounts":
        """The same table on ``device``."""
        return WideCounts(keys=self.keys.to(device),
                          length=self.length.to(device),
                          counts=self.counts.to(device),
                          n_unique=self.n_unique)

    def to_dict(self) -> dict[str, int]:
        t = self.trim()
        hi, lo, length, _, _ = t.to_numpy()
        strs = PackedKmers(hi=hi, lo=lo, length=length).to_strings()
        return {s: int(c) for s, c in zip(strs, t.counts64())}

    def total(self) -> int:
        return int(self.counts.sum())

    def distinct(self) -> int:
        return int(self.n_unique)

    @staticmethod
    def empty(capacity: int, device: str | torch.device = "cpu"
              ) -> "WideCounts":
        return _fit(*(torch.zeros(0, dtype=dt, device=device)
                      for dt in (torch.int64, torch.int32, torch.int64)),
                    capacity)


def _fit(keys, length, counts, capacity: int) -> WideCounts:
    """Live rows (in key order) -> a WideCounts of ``capacity`` slots:
    dead-slot padding, or the first ``capacity`` rows on overflow, with
    ``n_unique`` the exact row count either way."""
    n = keys.numel()
    live = min(n, capacity)
    dev = keys.device
    out_keys = torch.full((capacity,), SENTINEL_KEY, dtype=torch.int64,
                          device=dev)
    out_len = torch.full((capacity,), int(SENTINEL_LEN), dtype=torch.int32,
                         device=dev)
    out_counts = torch.zeros(capacity, dtype=torch.int64, device=dev)
    out_keys[:live] = keys[:live]
    out_len[:live] = length[:live]
    out_counts[:live] = counts[:live]
    return WideCounts(keys=out_keys, length=out_len, counts=out_counts,
                      n_unique=n)


def _live(keys, length, counts):
    """The rows with a count > 0 (stream compaction; keeps their order)."""
    idx = torch.nonzero(counts > 0).squeeze(1)
    return keys[idx], length[idx], counts[idx]


def _group(keys, length, counts):
    """64-bit weighted GROUP BY (key, length) of the live rows, in
    ascending unsigned key order and then length: two stable sorts (torch
    has no multi-key sort), then segment totals from an int64 cumsum."""
    keys, length, counts = _live(keys, length, counts.to(torch.int64))
    order = torch.sort(length, stable=True).indices
    order = order[torch.sort((keys ^ SIGN_FLIP)[order], stable=True).indices]
    keys, length, counts = keys[order], length[order], counts[order]
    n = keys.numel()
    if n == 0:
        return keys, length, counts
    tail = torch.ones(n, dtype=torch.bool, device=keys.device)
    tail[:-1] = (keys[1:] != keys[:-1]) | (length[1:] != length[:-1])
    ends = torch.nonzero(tail).squeeze(1)
    csum = torch.cumsum(counts, 0)[ends]
    totals = csum.clone()
    totals[1:] -= csum[:-1]
    return keys[ends], length[ends], totals


def count_packed_wide(keys, length, counts, capacity: int) -> WideCounts:
    """64-bit weighted GROUP BY, compacted to ``capacity`` slots.

    A key may carry weight in any number of slots (the K-way merge of
    spill runs); slots of weight 0 are absent.  Past ``capacity`` the
    largest keys are dropped and ``n_unique > capacity`` says so.
    """
    return _fit(*_group(keys, length, counts), capacity)


def wide_from_table(table: CountTable, capacity: int | None = None
                    ) -> WideCounts:
    """Lift a CountTable (int32 sorted-run layout) into compacted wide
    form; the capacity defaults to the table's slot count."""
    cap = table.capacity if capacity is None else capacity
    return count_packed_wide(table.keys, table.length, table.counts, cap)


def merge_into_wide(acc: WideCounts, table: CountTable) -> WideCounts:
    """Accumulate a per-batch CountTable into a wide accumulator; keeps
    ``acc.capacity``, so overflow is ``n_unique > capacity``."""
    return count_packed_wide(
        torch.cat([acc.keys, table.keys]),
        torch.cat([acc.length, table.length.to(torch.int32)]),
        torch.cat([acc.counts, table.counts.to(torch.int64)]),
        acc.capacity)


def merge_wide(a: WideCounts, b: WideCounts, capacity: int | None = None
               ) -> WideCounts:
    """Associative merge of two wide tables."""
    return count_packed_wide(
        torch.cat([a.keys, b.keys]), torch.cat([a.length, b.length]),
        torch.cat([a.counts, b.counts]),
        a.capacity if capacity is None else capacity)


def pad_wide(acc: WideCounts, capacity: int) -> WideCounts:
    """Re-home a compacted accumulator into a larger capacity (dead-slot
    padding; the live slots are already at the front in key order)."""
    if capacity <= acc.capacity:
        return acc
    pad = capacity - acc.capacity

    def ext(x, fill):
        return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                        device=x.device)])

    return WideCounts(keys=ext(acc.keys, SENTINEL_KEY),
                      length=ext(acc.length, int(SENTINEL_LEN)),
                      counts=ext(acc.counts, 0), n_unique=acc.n_unique)


# --- the streaming fold ---------------------------------------------------


def table_groups(table: CountTable) -> tuple[torch.Tensor, torch.Tensor]:
    """A sorted-run table's live groups (keys, int64 counts), in key
    order: a stream compaction of the slots with a count."""
    idx = torch.nonzero(table.counts > 0).squeeze(1)
    return table.keys[idx], table.counts[idx].to(torch.int64)


def live_rows(acc: WideCounts) -> tuple[torch.Tensor, torch.Tensor]:
    """An accumulator's live (keys, counts), by ``counts > 0``."""
    keys, _, counts = _live(acc.keys, acc.length, acc.counts)
    return keys, counts


def merge_groups(a_keys, a_counts, b_keys, b_counts
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two deduplicated (keys, counts) sets of one k.

    A key then sits in at most two slots, so after one sort of the
    sign-flipped keys each group's total is its head plus, where the next
    slot holds the same key, that slot: a neighbour add, no cumsum.
    Returns the merged live groups in ascending key order.
    """
    flipped, order = torch.sort(torch.cat([a_keys, b_keys]) ^ SIGN_FLIP)
    counts = torch.cat([a_counts, b_counts])[order]
    if flipped.numel() == 0:
        return flipped, counts
    same_next = flipped[1:] == flipped[:-1]
    head = torch.ones_like(flipped, dtype=torch.bool)
    head[1:] = ~same_next
    totals = counts.clone()
    totals[:-1] += torch.where(same_next, counts[1:], 0)
    idx = torch.nonzero(head).squeeze(1)
    return flipped[idx] ^ SIGN_FLIP, totals[idx]


def fit_groups(keys, counts, k: int, capacity: int) -> WideCounts:
    """Fixed-k live groups -> a WideCounts of ``capacity`` slots."""
    return _fit(keys, torch.full_like(keys, k, dtype=torch.int32), counts,
                capacity)


def fold_windows_into_wide(acc: WideCounts, keys: torch.Tensor,
                           valid: torch.Tensor | None, k: int) -> WideCounts:
    """Fold one batch of raw window keys into a wide accumulator: count
    the batch (sort + segment-count kernel), compact its live groups, and
    merge them with the accumulator's.  Keeps ``acc.capacity``;
    ``n_unique`` is exact, so ``n_unique > capacity`` signals overflow."""
    merged = merge_groups(*live_rows(acc),
                          *table_groups(count_windows(keys, valid, k)))
    return fit_groups(*merged, k, acc.capacity)


# --- spill runs -------------------------------------------------------------

# a device K-way run merge beyond this size would not fit comfortably
# next to the working set; the host numpy path takes over
_DEVICE_MERGE_MAX_ROWS = 1 << 26


def merge_runs(runs: list[WideCounts], prefer_device: bool = True, *,
               device: str | torch.device) -> WideCounts:
    """Exact K-way merge of spilled runs; a key may sit in all K.

    Up to ``_DEVICE_MERGE_MAX_ROWS`` rows the merge is the general
    weighted GROUP BY on ``device``; above that it runs on the host with
    numpy (lexsort + reduceat), bounded by host memory, not the card's.
    Returns a trimmed host table either way.
    """
    trims = [r.trim() for r in runs] or [WideCounts.empty(0)]
    keys = torch.cat([t.keys for t in trims])
    length = torch.cat([t.length for t in trims])
    counts = torch.cat([t.counts for t in trims])
    n = keys.numel()
    if prefer_device and n <= _DEVICE_MERGE_MAX_ROWS:
        return count_packed_wide(keys.to(device), length.to(device),
                                 counts.to(device), capacity=n).trim()
    k64 = keys.numpy().view(np.uint64)
    ln = length.numpy()
    c64 = counts.numpy()
    order = np.lexsort((ln, k64))
    k64, ln, c64 = k64[order], ln[order], c64[order]
    head = np.ones(n, bool)
    head[1:] = (k64[1:] != k64[:-1]) | (ln[1:] != ln[:-1])
    starts = np.flatnonzero(head)
    totals = np.add.reduceat(c64, starts) if n else c64
    return WideCounts(keys=torch.from_numpy(k64[starts].view(np.int64)),
                      length=torch.from_numpy(ln[starts]),
                      counts=torch.from_numpy(totals.astype(np.int64)),
                      n_unique=int(starts.size))


class SpillRuns:
    """Spilled sorted runs: host tables, or ``spill_NNNNN.npz`` files in
    ``kmer_tpu``'s lanes under a directory (so either package reads the
    other's runs)."""

    def __init__(self, spill_dir: str | None):
        self.dir = spill_dir
        self.runs: list = []  # host WideCounts or npz paths

    def spill(self, acc: WideCounts) -> bool:
        """Adds the accumulator's live rows as a run (none if empty)."""
        t = acc.trim()
        if t.n_unique == 0:
            return False
        if self.dir is None:
            self.runs.append(t)
            return True
        from ..utils.checkpoint import atomic_savez

        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"spill_{len(self.runs):05d}.npz")
        hi, lo, length, counts_hi, counts_lo = t.to_numpy()
        atomic_savez(path, compress=False, hi=hi, lo=lo, length=length,
                     counts_hi=counts_hi, counts_lo=counts_lo)
        self.runs.append(path)
        return True

    def load(self) -> list[WideCounts]:
        out = []
        for r in self.runs:
            if isinstance(r, str):
                with np.load(r, allow_pickle=False) as z:
                    r = WideCounts.from_numpy(z["hi"], z["lo"], z["length"],
                                              z["counts_hi"], z["counts_lo"])
            out.append(r)
        return out


class WideAccumulator:
    """Streaming 64-bit exact accumulator of per-batch CountTables, with
    geometric growth and, past a device budget, spills.

    ``add(table)`` merges a sorted-run CountTable into a compacted
    WideCounts.  Growth never drops keys: once the upper bound on the
    distinct count (last known ``n_unique`` + slots added since) could
    pass the capacity, the accumulator is re-homed into the next power of
    two before the merge.  ``max_capacity`` is the device budget in
    slots: instead of growing past it, the live slots spill to host
    memory (or to npz files under ``spill_dir``) as a sorted run, and
    ``result()`` finishes with their exact K-way merge.
    """

    def __init__(self, capacity: int = 1 << 16,
                 max_capacity: int | None = None,
                 spill_dir: str | None = None, *,
                 device: str | torch.device):
        self._device = torch.device(device)
        self._cap = 1 << max(3, int(capacity - 1).bit_length())
        self._acc: WideCounts | None = None
        self._bound = 0  # upper bound on the current n_unique
        if max_capacity is not None:
            # the budget rounds DOWN to a power of two (growth doubles
            # from one), and the starting capacity clamps to it
            max_capacity = max(8, 1 << (int(max_capacity).bit_length() - 1))
            self._cap = min(self._cap, max_capacity)
        self._max_cap = max_capacity
        self._runs = SpillRuns(spill_dir)

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def n_spills(self) -> int:
        return len(self._runs.runs)

    @property
    def empty(self) -> bool:
        return self._acc is None and not self._runs.runs

    def seed(self, acc: WideCounts) -> None:
        """Adopt an existing accumulator (checkpoint resume)."""
        self._cap = acc.capacity
        self._acc = acc.to(self._device)
        self._bound = acc.n_unique

    def add(self, table: CountTable) -> None:
        """Fold one per-batch CountTable (sorted-run layout) in, exactly."""
        batch_cap = table.capacity
        if self._acc is None:
            self._acc = WideCounts.empty(self._cap, self._device)
        if self._bound + batch_cap > self._cap:
            n = self._acc.n_unique
            if n + batch_cap > self._cap:
                new_cap = 1 << int(n + batch_cap - 1).bit_length()
                if self._max_cap is not None and new_cap > self._max_cap:
                    if self._runs.spill(self._acc):
                        self._acc = WideCounts.empty(self._cap, self._device)
                        self._bound = 0
                    if batch_cap > self._max_cap:
                        raise ValueError(
                            f"one batch table ({batch_cap} slots) exceeds "
                            f"max_capacity {self._max_cap}; shrink the batch"
                        )
                    while self._cap < batch_cap:
                        self._cap *= 2
                        self._acc = pad_wide(self._acc, self._cap)
                else:
                    self._acc = pad_wide(self._acc, new_cap)
                    self._cap = new_cap
                    self._bound = n
            else:
                self._bound = n
        self._acc = merge_into_wide(self._acc, table)
        self._bound += batch_cap

    def result(self) -> WideCounts:
        """The exact accumulated table: the device accumulator, or with
        spills the host K-way merge of every run and the live slots."""
        if self.empty:
            raise ValueError("empty accumulator")
        if not self._runs.runs:
            return self._acc
        runs = self._runs.load()
        if self._acc is not None:
            runs.append(self._acc.trim())
        return merge_runs(runs, device=self._device)
