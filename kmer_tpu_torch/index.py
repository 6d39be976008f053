"""Sorted radix index and hash index over a kmer column.

The counterpart of ``kmer_tpu/index.py``, the engine's replacement for
the reference's SP-GiST trie (kmer_spgist.c:102-566; strategies = (3),
@> (7), <@ (8), ^@ (28)).  Because 2-bit code order equals byte order and
keys are left-aligned with zero padding, every trie query is a contiguous
range of the column sorted by (key, length):

* equality      -> the range of the (key, length) pair;
* ^@ prefix p   -> keys in [pack(p), pack(p) + 4^(32-|p|)) with length
                   >= |p| (shorter keys that are prefixes of p land in the
                   range but must not match, kmer_spgist.c:520-536);
* qkmer @>      -> the range of the longest determinate leading run
                   (inner_consistent's pruning, kmer_spgist.c:395-444),
                   then a positionwise IUPAC mask check over it.

``KmerIndex`` is the host (numpy) index; ``DeviceIndex`` keeps the sorted
column and row ids on a device and answers batches of queries with a
vectorized lexicographic binary search; ``DeviceHashIndex`` is a
bucketized open-addressing table for equality (the reference's hash
opclass, kmer.c:353-365), built on the host, probed on the device.

On the device a key is one int64 (``packed.KmerColumn``).  Key order is
unsigned, so every comparison runs on ``key ^ SIGN_FLIP`` and then the
length; ``>>`` on int64 is arithmetic, so a shifted key is masked.  Row
ids are int64.  Inside an equal (key, length) group the device sort keeps
row order (two stable sorts), like ``KmerIndex``'s ``np.lexsort``.

Parity contract: index search results equal scan results (kmer-tests.sql
TEST 14).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import codec
from .ops.predicates import (
    _hash_finalize_np,
    as_int32_bits,
    hash_u32,
    qkmer_mask_vector,
)
from .packed import SIGN_FLIP, KmerColumn, PackedKmers
from .types import Kmer, Qkmer

_INT64_MAX = (1 << 63) - 1


@dataclasses.dataclass
class KmerIndex:
    """Host-built sorted index over a kmer column.

    sorted_keys:  [N] uint64 left-aligned packed keys, ascending
    sorted_lens:  [N] int32 lengths (secondary sort key)
    row_ids:      [N] int64 original row positions
    """

    sorted_keys: np.ndarray
    sorted_lens: np.ndarray
    row_ids: np.ndarray

    @classmethod
    def build(cls, column: PackedKmers) -> "KmerIndex":
        keys = column.key64()
        lens = np.asarray(column.length, np.int32)
        order = np.lexsort((lens, keys))  # primary: keys, secondary: lens
        return cls(sorted_keys=keys[order], sorted_lens=lens[order],
                   row_ids=order.astype(np.int64))

    @classmethod
    def from_strings(cls, kmers) -> "KmerIndex":
        return cls.build(PackedKmers.from_strings(kmers))

    def __len__(self) -> int:
        return int(self.sorted_keys.size)

    def _key_range(self, key: np.uint64, length: int) -> tuple[int, int]:
        """[l, r) of rows with exactly this (key, length)."""
        l = int(np.searchsorted(self.sorted_keys, key, side="left"))
        r = int(np.searchsorted(self.sorted_keys, key, side="right"))
        if l == r:
            return l, r
        lens = self.sorted_lens[l:r]
        return (l + int(np.searchsorted(lens, length, side="left")),
                l + int(np.searchsorted(lens, length, side="right")))

    def _prefix_range(self, codes: np.ndarray) -> tuple[int, int]:
        """[l, r) of rows whose key starts with the code prefix, in Python
        ints: the bound of an all-t prefix is 2^64."""
        p = int(codes.size)
        if p == 0:
            return 0, len(self)
        base = int(codec.pack_key64(codes))
        upper = base + (1 << (64 - 2 * p))
        l = int(np.searchsorted(self.sorted_keys, np.uint64(base), side="left"))
        if upper >= 1 << 64:
            return l, len(self)
        return l, int(np.searchsorted(self.sorted_keys, np.uint64(upper),
                                      side="left"))

    def search_eq(self, kmer) -> np.ndarray:
        """Row ids where row = kmer (strategy 3, kmer_spgist.c:510-519)."""
        km = Kmer(kmer)
        l, r = self._key_range(km.key64, len(km))
        return np.sort(self.row_ids[l:r])

    def search_prefix(self, prefix) -> np.ndarray:
        """Row ids where row ^@ prefix (strategy 28, kmer_spgist.c:520-536)."""
        pf = Kmer(prefix)
        l, r = self._prefix_range(pf.codes)
        hit = self.sorted_lens[l:r] >= len(pf)
        return np.sort(self.row_ids[l:r][hit])

    def search_pattern(self, qkmer) -> np.ndarray:
        """Row ids where qkmer @> row (strategies 7/8, kmer_spgist.c:537-556)."""
        qk = Qkmer(qkmer)
        qlen = len(qk)
        lead = qk.leading_exact_codes()
        l, r = self._prefix_range(lead)
        keys = self.sorted_keys[l:r]
        ok = self.sorted_lens[l:r] == qlen
        for i in range(len(lead), qlen):
            code = ((keys >> np.uint64(62 - 2 * i)) & np.uint64(3)).astype(np.uint8)
            ok = ok & (((qk.masks[i] >> code) & 1) != 0)
        return np.sort(self.row_ids[l:r][ok])


# --- device-side range lookup ------------------------------------------------


def _lex_less(akey, aln, bkey, bln, or_equal: bool) -> torch.Tensor:
    """(akey, aln) < (bkey, bln) in unsigned key order, then length."""
    fa, fb = akey ^ SIGN_FLIP, bkey ^ SIGN_FLIP
    same = fa == fb
    if or_equal:
        return (fa < fb) | (same & (aln <= bln))
    return (fa < fb) | (same & (aln < bln))


def _steps(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2)))) + 1


@dataclasses.dataclass
class SearchFence:
    """Sampled top level of the sorted column (the SP-GiST inner-node
    analogue): ``fence[t]`` is the first row whose key's top ``bits`` bits
    equal or exceed t, so a lookup starts in a small bucket and needs only
    ``steps`` probes (from the largest bucket at build time), not
    log2(N)."""

    fence: torch.Tensor  # [2^bits + 1] int64
    bits: int
    steps: int

    @classmethod
    def build(cls, skey: torch.Tensor, bits: int = 18) -> "SearchFence":
        if not 1 <= bits <= 32:
            raise ValueError(f"fence bits must be in [1, 32], got {bits}")
        n = skey.numel()
        probes = torch.arange(1 << bits, dtype=torch.int64,
                              device=skey.device) << (64 - bits)
        pos = torch.searchsorted(skey ^ SIGN_FLIP, probes ^ SIGN_FLIP,
                                 side="left")
        fence = torch.cat([pos, pos.new_full((1,), n)])
        max_bucket = int((fence[1:] - fence[:-1]).max()) if n else 1
        return cls(fence=fence, bits=bits, steps=_steps(max_bucket))


def searchsorted_packed(skey, sln, qkey, qln, side: str = "left",
                        fence: SearchFence | None = None) -> torch.Tensor:
    """Insertion positions (int64) of the queries ``(qkey, qln)`` [M] in
    the column ``(skey, sln)`` [N] sorted by (key, length); vectorized
    over M, ``log2(N) + 1`` probes, or ``fence.steps`` from the query's
    fence bucket."""
    n = skey.numel()
    qkey = qkey.reshape(-1)
    qln = qln.reshape(-1)
    if fence is not None:
        t = (qkey >> (64 - fence.bits)) & ((1 << fence.bits) - 1)
        lo_b, hi_b = fence.fence[t], fence.fence[t + 1]
        steps = fence.steps
    else:
        lo_b = torch.zeros(qkey.shape, dtype=torch.int64, device=qkey.device)
        hi_b = torch.full(qkey.shape, n, dtype=torch.int64,
                          device=qkey.device)
        steps = _steps(n)
    if n == 0:
        return lo_b
    for _ in range(steps):
        active = lo_b < hi_b
        mid = (lo_b + hi_b) // 2
        safe = mid.clamp(max=n - 1)
        go_right = _lex_less(skey[safe], sln[safe], qkey, qln,
                             or_equal=side == "right")
        lo_b = torch.where(active & go_right, mid + 1, lo_b)
        hi_b = torch.where(active & ~go_right, mid, hi_b)
    return lo_b


def prefix_upper_key(qkey: torch.Tensor, qln: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exclusive upper-bound key of a packed prefix, pack(p) + 4^(32-|p|)
    mod 2^64, and ``wrapped``: true where the sum reached 2^64 (the all-t
    prefix), so the range runs to the end.  An empty prefix has no bound
    (callers take the whole column); it is given |p| = 1's.

    No signed add overflows: where the sum wraps the key is negative as
    an int64 and the plain add lands in [0, 2^63); elsewhere the add runs
    on the flipped key, which stays under 2^63.
    """
    inc = torch.ones_like(qkey) << (64 - 2 * qln.to(torch.int64).clamp(min=1))
    flipped = qkey ^ SIGN_FLIP
    wrapped = flipped > _INT64_MAX - inc
    zero = torch.zeros_like(inc)
    ukey = torch.where(
        wrapped, qkey + torch.where(wrapped, inc, zero),
        (flipped + torch.where(wrapped, zero, inc)) ^ SIGN_FLIP)
    return ukey, wrapped


def device_sort_column(col: KmerColumn) -> tuple[KmerColumn, torch.Tensor]:
    """On-device index build: the column sorted by (key, length) and the
    row ids (int64), by a stable sort on the length and then one on the
    flipped key."""
    order = torch.sort(col.length, stable=True).indices
    order = order[torch.sort((col.key ^ SIGN_FLIP)[order], stable=True).indices]
    return KmerColumn(key=col.key[order], length=col.length[order]), order


def _gather_block(row_ids, start, valid, cap: int) -> torch.Tensor:
    """row_ids[start + j] for j < cap where valid, else -1."""
    n = row_ids.numel()
    if n == 0:
        return torch.full(valid.shape, -1, dtype=torch.int64,
                          device=row_ids.device)
    offs = torch.arange(cap, dtype=torch.int64, device=row_ids.device)
    pos = (start[:, None] + offs[None, :]).clamp(0, n - 1)
    return torch.where(valid, row_ids[pos], -1)


@dataclasses.dataclass(frozen=True)
class DeviceIndex:
    """Column sorted by (key, length) + original row ids, on a device.

    Range queries return [M] (start, end) pairs; row materialization
    returns a fixed [M, cap] block and its validity mask.
    """

    key: torch.Tensor
    length: torch.Tensor
    row_ids: torch.Tensor

    @classmethod
    def build(cls, column: KmerColumn) -> "DeviceIndex":
        sorted_col, rid = device_sort_column(column)
        return cls(key=sorted_col.key, length=sorted_col.length, row_ids=rid)

    def __len__(self) -> int:
        return int(self.key.numel())

    def eq_ranges(self, qkey, qln, fence: SearchFence | None = None):
        """[start, end) per query with exactly this (key, length): strategy 3."""
        return (searchsorted_packed(self.key, self.length, qkey, qln,
                                    "left", fence),
                searchsorted_packed(self.key, self.length, qkey, qln,
                                    "right", fence))

    def build_fence(self, bits: int = 18) -> SearchFence:
        return SearchFence.build(self.key, bits=bits)

    def prefix_ranges(self, qkey, qln, fence: SearchFence | None = None):
        """[start, end) per query of the rows starting with the prefix
        (strategy 28).  qkey: packed prefixes (zero padding); qln: their
        lengths, 0 meaning every row.

        The length filter folds into the bounds: a key strictly inside
        (pack(p), pack(p) + 4^(32-|p|)) has length >= |p|, and the only
        shorter keys in range sit at pack(p) with length < |p|, which the
        left probe's length lane |p| excludes.
        """
        n = len(self)
        qkey = qkey.reshape(-1)
        qln = qln.reshape(-1)
        left = searchsorted_packed(self.key, self.length, qkey, qln, "left",
                                   fence)
        ukey, wrapped = prefix_upper_key(qkey, qln)
        right = searchsorted_packed(self.key, self.length, ukey,
                                    torch.full_like(qln, -1), "left", fence)
        right = torch.where(wrapped, n, right)
        empty = qln == 0
        return torch.where(empty, 0, left), torch.where(empty, n, right)

    def gather_rows(self, left, right, cap: int):
        """Row ids of each [start, end), padded with -1 to a static cap:
        (rows [M, cap] int64, valid [M, cap] bool).  Wider ranges are
        cut at cap."""
        offs = torch.arange(cap, dtype=torch.int64, device=left.device)
        valid = left[:, None] + offs[None, :] < right[:, None]
        return _gather_block(self.row_ids, left, valid, cap), valid

    def pattern_hits(self, masks, qlen: int, cap: int):
        """Batched qkmer containment (strategies 7/8, kmer_spgist.c:537-556).

        masks: [M, MAX_K] 4-bit IUPAC masks (``qkmer_mask_vector`` rows);
        qlen: the batch's pattern length; cap: candidates per query.  Each
        query prunes to the range of its determinate leading run, takes up
        to cap candidates and checks every position.  Returns (rows [M,
        cap] int64, -1 padded; hit [M, cap] bool; truncated [M] bool, true
        where the candidates overflowed cap).
        """
        dev = self.key.device
        if not isinstance(masks, torch.Tensor):
            masks = torch.from_numpy(np.asarray(masks, dtype=np.int64))
        masks = masks.to(device=dev, dtype=torch.int64)
        m = masks[:, :qlen]
        is_exact = (m == 1) | (m == 2) | (m == 4) | (m == 8)
        lead_len = torch.argmin(torch.cat(
            [is_exact, is_exact.new_zeros((m.shape[0], 1))], 1).to(torch.int32),
            dim=1)
        # a one-hot mask's code is log2(mask)
        codes = ((m >> 1) & 1) | (((m >> 2) & 1) * 2) | (((m >> 3) & 1) * 3)
        qkey = torch.zeros(m.shape[0], dtype=torch.int64, device=dev)
        for i in range(int(qlen)):
            qkey |= torch.where(i < lead_len, codes[:, i], 0) << (62 - 2 * i)
        left, right = self.prefix_ranges(qkey, lead_len.to(torch.int32))
        truncated = (right - left) > cap

        n = len(self)
        offs = torch.arange(cap, dtype=torch.int64, device=dev)
        ppos = left[:, None] + offs[None, :]
        in_range = ppos < right[:, None]
        if n == 0:
            rows = torch.full(ppos.shape, -1, dtype=torch.int64, device=dev)
            return rows, in_range, truncated
        safe = ppos.clamp(0, n - 1)
        ckey = self.key[safe]
        ok = in_range & (self.length[safe] == qlen)
        for i in range(int(qlen)):
            code = (ckey >> (62 - 2 * i)) & 3
            ok &= ((masks[:, i: i + 1] >> code) & 1) != 0
        return torch.where(ok, self.row_ids[safe], -1), ok, truncated

    def search_pattern_batch(self, qkmers, cap: int = 64) -> list[np.ndarray]:
        """Exact batched qkmer containment with cap regrowth: a group that
        overflowed is issued again with 4x the cap until nothing truncates.
        Queries are grouped by pattern length.  Returns sorted row-id
        arrays per query."""

        def group_fn(qlen, masks, c):
            rows, ok, truncated = self.pattern_hits(masks, qlen=qlen, cap=c)
            rows, ok = rows.cpu().numpy(), ok.cpu().numpy()
            return ([np.sort(rows[j][ok[j]]) for j in range(rows.shape[0])],
                    bool(truncated.any()))

        zero_rows = np.sort(self.row_ids[self.length == 0].cpu().numpy())
        return pattern_search_grouped(qkmers, zero_rows, group_fn, cap,
                                      cap_limit=max(len(self), 1))


_CAP_LADDER_BASE = 8


def ladder_cap(cap: int, limit: int) -> int:
    """Snap a candidate cap up to the geometric ladder {8, 32, 128, ...},
    clamped to ``limit``, so 4x regrowth from any cap issues the same
    groups in both packages."""
    c = _CAP_LADDER_BASE
    while c < cap:
        c *= 4
    return min(c, limit) if limit else c


def pattern_search_grouped(qkmers, zero_len_rows, group_fn, cap: int,
                           cap_limit: int) -> list[np.ndarray]:
    """Exact pattern search over a group function: groups patterns by
    length, answers the zero-length pattern with ``zero_len_rows`` (it
    matches only empty kmers), and grows the cap 4x until
    ``group_fn(qlen, masks [M, MAX_K], cap) -> (rows_per_query,
    any_truncated)`` reports no truncation or the cap reaches
    ``cap_limit`` (the whole column)."""
    qkmers = [Qkmer(q) for q in qkmers]
    out: list[np.ndarray | None] = [None] * len(qkmers)
    by_len: dict[int, list[int]] = {}
    for i, q in enumerate(qkmers):
        by_len.setdefault(len(q), []).append(i)
    for qlen, ids in by_len.items():
        if qlen == 0:
            for i in ids:
                out[i] = zero_len_rows
            continue
        masks = np.stack([qkmer_mask_vector(qkmers[i])[0] for i in ids])
        c = ladder_cap(cap, cap_limit)
        while True:
            rows, truncated = group_fn(qlen, masks, min(c, cap_limit))
            if not truncated or c >= cap_limit:
                if truncated:
                    raise RuntimeError("a cap covering the column truncated")
                for j, i in enumerate(ids):
                    out[i] = rows[j]
                break
            c *= 4
    return out  # type: ignore[return-value]


# --- device hash index ---------------------------------------------------------
#
# Equality lookups probe a bucketized open-addressing table instead of
# binary-searching the sorted column: each bucket's 8 slots are one
# contiguous [8, 5] int32 row, so a probe is max_chain (typically 1-2) row
# gathers, not log2(N) dependent ones.


_BUCKET = 8


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@dataclasses.dataclass
class DeviceHashIndex:
    """Bucketized open-addressing hash table over the unique (key, length)s.

    table:     [nb, 8, 5] int32 on the device; per slot (hi, lo, length,
               group_start, group_count) with hi and lo as int32 bits and
               length -1 marking an empty slot; groups point into row_ids.
    row_ids:   [N] int64 row positions, grouped by key in ascending order.
    max_chain: the bucket-probe bound found at build time.
    """

    table: torch.Tensor
    row_ids: torch.Tensor
    max_chain: int
    n_unique: int

    @classmethod
    def build(cls, column: PackedKmers, load: float = 0.25, *,
              device) -> "DeviceHashIndex":
        """Vectorized numpy build on the host (``kmer_tpu``'s placement,
        slot for slot); the table and row ids go to ``device``."""
        n = len(column)
        keys = column.key64()
        lens = np.asarray(column.length, np.int32)
        order = np.lexsort((lens, keys))
        skeys, slens = keys[order], lens[order]
        new = np.ones(n, bool)
        new[1:] = (skeys[1:] != skeys[:-1]) | (slens[1:] != slens[:-1])
        gstart = np.flatnonzero(new).astype(np.int32)
        u = gstart.size
        gcount = np.diff(np.append(gstart, n)).astype(np.int32)
        ghi = (skeys[gstart] >> np.uint64(32)).astype(np.uint32)
        glo = (skeys[gstart] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        gln = slens[gstart]

        # capacity covers every unique key whatever the load factor
        nb = _next_pow2(max(1, int(np.ceil(u / (_BUCKET * load))),
                            -(-int(u) // _BUCKET)))
        table = np.zeros((nb, _BUCKET, 5), np.int32)
        table[:, :, 2] = -1  # empty
        fill = np.zeros(nb, np.int32)

        home = (_hash_finalize_np(ghi, glo, gln)
                & np.uint32(nb - 1)).astype(np.int64)
        remaining = np.arange(u, dtype=np.int64)
        cur = home.copy()
        chain = 0
        while remaining.size:
            b = cur[remaining]
            # rank of each remaining group within its current bucket
            o = np.argsort(b, kind="stable")
            bs = b[o]
            run_start = np.ones(bs.size, bool)
            run_start[1:] = bs[1:] != bs[:-1]
            head = np.maximum.accumulate(
                np.where(run_start, np.arange(bs.size), 0))
            slot = fill[bs] + np.arange(bs.size) - head
            win = slot < _BUCKET
            gidx = remaining[o]
            wg, wb, ws = gidx[win], bs[win], slot[win]
            table[wb, ws, 0] = ghi[wg].view(np.int32)
            table[wb, ws, 1] = glo[wg].view(np.int32)
            table[wb, ws, 2] = gln[wg]
            table[wb, ws, 3] = gstart[wg]
            table[wb, ws, 4] = gcount[wg]
            np.add.at(fill, wb, 1)  # one increment per winner
            remaining = gidx[~win]
            if remaining.size:
                cur[remaining] = (cur[remaining] + 1) & (nb - 1)
                chain += 1
                if chain > nb:  # cannot happen: capacity >= u
                    raise RuntimeError("hash index build failed to place keys")

        return cls(table=torch.from_numpy(table).to(device),
                   row_ids=torch.from_numpy(order.astype(np.int64)).to(device),
                   max_chain=chain + 1, n_unique=int(u))

    def __len__(self) -> int:
        return int(self.row_ids.numel())

    def lookup_eq(self, qkey, qln):
        """Batched equality lookup: (group_start, group_count, found) per
        query; query i's rows are row_ids[start_i : start_i + count_i]."""
        return _hash_lookup(self.table, qkey, qln, self.max_chain)

    def gather_rows(self, start, count, cap: int):
        """Row ids per group, padded with -1 to a static cap."""
        offs = torch.arange(cap, dtype=torch.int64, device=start.device)
        valid = offs[None, :] < count[:, None]
        return (_gather_block(self.row_ids, start.to(torch.int64), valid, cap),
                valid)


def _hash_lookup(table, qkey, qln, max_chain: int):
    """Probe ``max_chain`` buckets from each query's home bucket; the
    table's hi and lo are int32 bits, so the query's are made int32 too."""
    nb = table.shape[0]
    qkey = qkey.reshape(-1)
    qln = qln.reshape(-1).to(torch.int32)
    h = hash_u32(qkey, qln) & (nb - 1)
    qhi = as_int32_bits((qkey >> 32) & 0xFFFFFFFF)[:, None]
    qlo = as_int32_bits(qkey & 0xFFFFFFFF)[:, None]
    m = qkey.numel()
    start = torch.zeros(m, dtype=torch.int32, device=qkey.device)
    count = torch.zeros_like(start)
    found = torch.zeros(m, dtype=torch.bool, device=qkey.device)
    for c in range(max_chain):
        bucket = table[(h + c) & (nb - 1)]  # [M, 8, 5]: one row gather
        mhit = ((bucket[:, :, 0] == qhi) & (bucket[:, :, 1] == qlo)
                & (bucket[:, :, 2] == qln[:, None]))
        sel = mhit.to(torch.int32)  # at most one hit a bucket
        take = mhit.any(1) & ~found
        start = torch.where(take, (bucket[:, :, 3] * sel).sum(1).to(torch.int32),
                            start)
        count = torch.where(take, (bucket[:, :, 4] * sel).sum(1).to(torch.int32),
                            count)
        found |= take
    return start, count, found
