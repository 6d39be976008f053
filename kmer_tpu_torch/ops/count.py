"""Exact k-mer counting (GROUP BY / COUNT / DISTINCT) on int64 keys.

The counterpart of ``kmer_tpu/ops/count.py``: sort the keys, then count
equal-key segments with the segment-count kernel.  The TPU version's k
tiers, uint16 lo lane and one-key group sort with odd-even fixup exist
because the TPU lacks a fast 64-bit sort; here they are one ``torch.sort``
of the sign-flipped int64 key.

Table layout ("sorted-run" form): a CountTable's ``keys`` hold the sorted
keys with duplicates in place; ``counts`` holds each segment's total in
one slot of the segment (the tail slot) and 0 elsewhere, so live groups
are ``counts > 0``, in ascending key order.

Two paths, as in ``kmer_tpu``:
* unit weights at one k (``count_windows``, ``count_kmers``,
  ``count_dna``): sort + the segment-count kernel;
* weighted GROUP BY over ``(key, length)`` (``count_packed``,
  ``count_column``, ``merge_tables``): plain torch, because equal keys of
  different lengths are different groups ('a', 'aa' and 'aaa' all have
  key 0) and the kernel compares keys alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.codes_keys import as_codes, codes_keys
from ..kernels.segment_counts import segment_counts
from ..packed import (
    SIGN_FLIP,
    KmerColumn,
    PackedKmers,
    key_from_hi_lo,
)
from ..types import Dna
from ..utils.profiling import span
from . import landing

# Sentinel lanes for invalid slots (the values of kmer_tpu/ops/count.py):
# an invalid window's key is all ones, and its length lane SENTINEL_LEN.
SENTINEL = np.uint32(0xFFFFFFFF)
SENTINEL_LEN = np.int32(0x7FFFFFFF)
SENTINEL_KEY = -1  # both lanes SENTINEL, as one int64


@dataclasses.dataclass(frozen=True)
class CountTable:
    """Sorted-run (keys, counts) table; groups live where counts > 0.

    keys: int64 [n] left-aligned keys, ascending in unsigned order;
    length: int32 [n]; counts: int32 [n]; n_unique: live-group count (a
    0-dim tensor, or an int on a trimmed table).
    """

    keys: torch.Tensor
    length: torch.Tensor
    counts: torch.Tensor
    n_unique: torch.Tensor | int

    @property
    def capacity(self) -> int:
        return int(self.keys.numel())

    def trim(self) -> "CountTable":
        """The live groups in ascending key order, as a host table.

        A mask select keeps key order (``landing.trim_rows``); from a card
        the rows land through the pinned ring in one host allocation, and
        a host table of live groups alone is not copied.
        """
        path, (keys, length, counts) = landing.trim_rows(
            self.keys, self.length, self.counts)
        if path == "host":
            return dataclasses.replace(self, n_unique=self.capacity)
        return CountTable(keys=keys, length=length, counts=counts,
                          n_unique=int(keys.numel()))

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
        """(hi uint32, lo uint32, length int32, counts int32): the arrays
        of a ``kmer_tpu`` CountTable with the same slots, rows of one new
        [4, n] buffer (``landing.split``)."""
        with span("to_numpy"):
            keys = landing.host_array(self.keys, np.int64)
            return landing.split((
                *landing.halves(keys, np.uint32),
                landing.host_array(self.length, np.int32),
                landing.host_array(self.counts, np.int32)))

    @classmethod
    def from_numpy(cls, hi, lo, length, counts, device="cpu") -> "CountTable":
        """A table from a ``kmer_tpu`` CountTable's (hi, lo, length,
        counts) arrays, on ``device``."""
        counts = torch.tensor(np.asarray(counts, np.int32), device=device)
        return cls(
            keys=torch.tensor(key_from_hi_lo(hi, lo), device=device),
            length=torch.tensor(np.asarray(length, np.int32), device=device),
            counts=counts,
            n_unique=(counts > 0).sum().to(torch.int32),
        )

    def to_dict(self) -> dict[str, int]:
        """{kmer string: count}: the GROUP BY result as a host dict."""
        hi, lo, length, counts = self.trim().to_numpy()
        strs = PackedKmers(hi=hi, lo=lo, length=length).to_strings()
        return {s: int(c) for s, c in zip(strs, counts)}

    def total(self) -> int:
        """COUNT(*): total weight across groups."""
        return int(self.counts.to(torch.int64).sum())

    def distinct(self) -> int:
        """COUNT(DISTINCT kmer)."""
        return int(self.n_unique)


def count_windows(keys: torch.Tensor, valid: torch.Tensor | None,
                  k: int) -> CountTable:
    """Unit-weight fixed-k counting of int64 window keys (any shape).

    With a validity mask and k <= 31, invalid slots fold into the all-ones
    sentinel, which no real key equals (its low padding bits are zero) and
    which sorts last; the kernel leaves it out.  For k = 32 an all-``t``
    32-mer equals the sentinel bit for bit, so the valid keys are selected
    before the sort instead.
    """
    keys = keys.reshape(-1)
    sentinel = None
    if valid is not None:
        valid = valid.reshape(-1)
        if k == 32:
            keys = keys[valid]
        else:
            keys = torch.where(valid, keys, SENTINEL_KEY)
            sentinel = SENTINEL_KEY ^ SIGN_FLIP
    flipped = torch.sort(keys ^ SIGN_FLIP).values
    counts, n_unique = segment_counts(flipped, sentinel)
    if sentinel is None:
        length = torch.full_like(counts, k)
    else:
        length = torch.where(flipped == sentinel, int(SENTINEL_LEN),
                             k).to(torch.int32)
    return CountTable(keys=flipped.bitwise_xor_(SIGN_FLIP), length=length,
                      counts=counts, n_unique=n_unique)


def count_packed(keys: torch.Tensor, length: torch.Tensor,
                 weights: torch.Tensor) -> CountTable:
    """Weighted GROUP BY over ``(key, length)`` (the general / merge path).

    Slots of weight <= 0 are absent.  The table has one slot per input
    slot: groups ascend in unsigned key order and then length, each total
    at its segment's tail slot; absent slots sort last as sentinels (key
    all ones, length SENTINEL_LEN, count 0).  Order comes from two stable
    sorts, by length and then by the flipped key.  Totals are int64 sums
    cast to the int32 counts lane: exact while a group's total fits int32,
    as ``kmer_tpu``'s are (its ``count_packed`` docstring), and wrapped
    mod 2^32 past that; 64-bit totals are ``ops/wide``'s.
    """
    keys = keys.reshape(-1)
    length = length.reshape(-1).to(torch.int32)
    weights = weights.reshape(-1).to(torch.int64)
    live = weights > 0
    keys = torch.where(live, keys, SENTINEL_KEY)
    length = torch.where(live, length, int(SENTINEL_LEN))
    weights = torch.where(live, weights, 0)
    order = torch.sort(length, stable=True).indices
    order = order[torch.sort((keys ^ SIGN_FLIP)[order], stable=True).indices]
    keys, length, weights = keys[order], length[order], weights[order]
    n = keys.numel()
    tail = torch.ones(n, dtype=torch.bool, device=keys.device)
    tail[:-1] = (keys[1:] != keys[:-1]) | (length[1:] != length[:-1])
    ends = torch.nonzero(tail).squeeze(1)
    csum = torch.cumsum(weights, 0)[ends]
    totals = csum.clone()
    totals[1:] -= csum[:-1]
    counts = torch.zeros(n, dtype=torch.int64, device=keys.device)
    counts[ends] = totals
    counts = torch.where(length == int(SENTINEL_LEN), 0,
                         counts).to(torch.int32)
    return CountTable(keys=keys, length=length, counts=counts,
                      n_unique=(counts > 0).sum().to(torch.int32))


def count_column(col: KmerColumn, valid: torch.Tensor | None = None
                 ) -> CountTable:
    """GROUP BY over a kmer column of mixed lengths (TEST 13); ``valid``
    leaves rows out."""
    w = (torch.ones_like(col.length) if valid is None
         else valid.to(torch.int32))
    return count_packed(col.key, col.length, w)


def merge_tables(a: CountTable, b: CountTable) -> CountTable:
    """Associative merge of two tables (counts add per group)."""
    return count_packed(torch.cat([a.keys, b.keys]),
                        torch.cat([a.length, b.length]),
                        torch.cat([a.counts, b.counts]))


def count_kmers(reads_codes: torch.Tensor, lengths: torch.Tensor, k: int,
                canonical: bool = False) -> CountTable:
    """Count every k-window of padded reads: codes [B, L], lengths [B].
    ``canonical`` counts min(kmer, revcomp); off for reference parity.
    The windows come from one ``codes_keys`` launch."""
    keys, valid = codes_keys(as_codes(reads_codes), lengths, k, canonical)
    return count_windows(keys, valid, k)


def count_dna(dna, k: int, canonical: bool = False, *,
              device: str | torch.device) -> CountTable:
    """generate_kmers + GROUP BY of one dna value, on ``device``."""
    device = resolve_device(device)
    codes = torch.from_numpy(Dna(dna).codes).to(device)
    lengths = torch.tensor([codes.numel()], dtype=torch.int32, device=device)
    return count_kmers(codes[None, :], lengths, k, canonical)
