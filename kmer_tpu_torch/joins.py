"""Joins over kmer columns (host side, numpy; the port's copy of
``kmer_tpu/joins.py``).

The reference's secondary suite (kmer-test.sql:104-407)
exercises inner/left/right joins on every predicate: ``a.kmer = b.kmer``,
``equals``, ``starts_with``, ``^@``, ``contains``/``@>``.  In Postgres
these run as hash joins (via kmer_hash_ops) or nested loops; the engine's
equivalents are sort-merge joins over the packed key order — build the
sorted radix index on the right column once, then batch-range-lookup
every left key (vectorized searchsorted + vectorized in-group length
bisection), expanding ranges to pairs.  No per-row Python loops: all
paths are O(pairs) numpy, scaling to the reference's 100k-row tables
and beyond.

All joins return an int64 [n_pairs, 2] array of (left_row, right_row)
ids, sorted by (left, right).
"""

from __future__ import annotations

import numpy as np

from .index import KmerIndex
from .packed import PackedKmers
from .types import Qkmer


def _bisect_lens(sorted_lens, s, e, targets, side: str) -> np.ndarray:
    """Vectorized per-range binary search of ``targets`` in
    sorted_lens[s:e) (lens ascend within each equal-key group)."""
    lo = s.astype(np.int64).copy()
    hi = e.astype(np.int64).copy()
    n = sorted_lens.size
    while True:
        active = lo < hi
        if not active.any():
            break
        mid = (lo + hi) // 2
        v = sorted_lens[np.clip(mid, 0, max(n - 1, 0))]
        if side == "left":
            go_right = v < targets
        else:
            go_right = v <= targets
        lo = np.where(active & go_right, mid + 1, lo)
        hi = np.where(active & ~go_right, mid, hi)
    return lo


def _expand_ranges(left_ids, starts, ends, right_order,
                   keep=None) -> np.ndarray:
    """(per-left [start, end) into right_order) -> (left, right) pairs.

    ``keep``: optional predicate on sorted positions — keep(pos) masks
    candidates after expansion (used by prefix joins to drop too-short
    rows inside the key range).
    """
    counts = (ends - starts).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros((0, 2), np.int64)
    li = np.repeat(left_ids, counts)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(total, dtype=np.int64) - np.repeat(offs, counts) + np.repeat(
        starts, counts
    )
    if keep is not None:
        sel = keep(pos)
        li, pos = li[sel], pos[sel]
    ri = right_order[pos]
    pairs = np.stack([li, ri], axis=1)
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    return pairs[order]


def join_eq(left: PackedKmers, right: PackedKmers) -> np.ndarray:
    """Pairs (i, j) with left[i] = right[j] (hash-join equivalent)."""
    idx = KmerIndex.build(right)
    lk = left.key64()
    ll = np.asarray(left.length, np.int64)
    # range by key64, then refine by length (the secondary sort key)
    # with a vectorized in-group bisection — no per-key Python loop
    s = np.searchsorted(idx.sorted_keys, lk, side="left")
    e = np.searchsorted(idx.sorted_keys, lk, side="right")
    starts = _bisect_lens(idx.sorted_lens, s, e, ll, "left")
    ends = _bisect_lens(idx.sorted_lens, s, e, ll, "right")
    return _expand_ranges(
        np.arange(lk.size, dtype=np.int64), starts, ends, idx.row_ids
    )


def join_right_starts_with_left(left: PackedKmers, right: PackedKmers) -> np.ndarray:
    """Pairs (i, j) where right[j] ^@ left[i] (left values are prefixes).

    Covers the reference's ``starts_with(a.kmer, b.kmer)`` /
    ``b.kmer ^@ a.kmer`` join shapes.  Vectorized: prefix key ranges via
    two searchsorted passes (upper bound = key + 4^(32-p), with the
    all-t overflow handled by clamping to n), then a post-expansion
    length filter.
    """
    idx = KmerIndex.build(right)
    lk = left.key64()
    ll = np.asarray(left.length, np.int64)
    n = len(idx)

    starts = np.searchsorted(idx.sorted_keys, lk, side="left").astype(np.int64)
    # span of a p-base prefix: 4^(32-p); p == 0 spans everything and
    # base + span overflows exactly when the prefix is all-t
    p = ll
    span = np.zeros_like(lk)
    nz = p > 0
    span[nz] = np.uint64(1) << (64 - 2 * p[nz]).astype(np.uint64)
    upper = lk + span  # wraps to 0 only for the all-t full-length prefix
    wrapped = nz & (upper < lk)
    ends = np.where(
        nz & ~wrapped,
        np.searchsorted(idx.sorted_keys, upper, side="left"),
        n,
    ).astype(np.int64)
    starts = np.where(nz, starts, 0)

    # pmap[t] = required min length for the t-th expanded candidate
    pmap = np.repeat(p, np.maximum(ends - starts, 0))
    lens = idx.sorted_lens

    def keep(pos, pmap=pmap, lens=lens):
        return lens[pos] >= pmap

    return _expand_ranges(
        np.arange(lk.size, dtype=np.int64), starts, ends, idx.row_ids, keep=keep
    )


def join_pattern(qkmers: list[Qkmer], right: PackedKmers) -> np.ndarray:
    """Pairs (i, j) where qkmers[i] @> right[j] (pattern join).

    One vectorized pattern probe per distinct qkmer (patterns prune to a
    candidate key range, then mask-check); pair assembly is numpy.
    """
    idx = KmerIndex.build(right)
    parts = []
    for i, qk in enumerate(qkmers):
        hits = np.asarray(idx.search_pattern(qk), np.int64)
        if hits.size:
            parts.append(
                np.stack([np.full(hits.size, i, np.int64), hits], axis=1)
            )
    if not parts:
        return np.zeros((0, 2), np.int64)
    out = np.concatenate(parts, axis=0)
    return out[np.lexsort((out[:, 1], out[:, 0]))]


def outer_extend(pairs: np.ndarray, n_left: int, n_right: int, how: str) -> list[tuple]:
    """LEFT/RIGHT/FULL join row lists with None for non-matches."""
    rows = [(int(a), int(b)) for a, b in pairs]
    if how in ("left", "full"):
        matched = np.zeros(n_left, bool)
        if len(pairs):
            matched[pairs[:, 0]] = True
        rows += [(i, None) for i in np.flatnonzero(~matched)]
    if how in ("right", "full"):
        matched = np.zeros(n_right, bool)
        if len(pairs):
            matched[pairs[:, 1]] = True
        rows += [(None, j) for j in np.flatnonzero(~matched)]
    return sorted(rows, key=lambda t: (t[0] is None, t[0], t[1] is None, t[1]))
