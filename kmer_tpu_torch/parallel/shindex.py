"""Sharded index serving over the "data" axis of a mesh of ranks.

The counterpart of ``kmer_tpu/parallel/shindex.py``, the mesh-wide form of
``DeviceIndex``:

* build: the column shards over "data" (rows padded to a multiple of the
  mesh's ranks) and each rank sorts its own shard by (key, length);
  padding rows (sentinel key, length ``SENTINEL_LEN``) sort last, and
  every lookup clamps its range to the shard's live rows;
* serve: every rank answers every query with a binary search of its
  shard (``searchsorted_packed``) and gathers up to ``cap`` candidate
  rows; the shards' (rows, hit) blocks are all-gathered over "data" and
  the exact hit counts summed over "data" (the psum), so a query's
  answer is the union over shards on every rank.

Every rank is given the whole column and the same queries.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index import (
    DeviceIndex, device_sort_column, ladder_cap, pattern_search_grouped,
    prefix_upper_key, searchsorted_packed)
from ..ops.count import SENTINEL_KEY, SENTINEL_LEN
from ..packed import KmerColumn, PackedKmers, key_from_hi_lo
from ..types import Kmer
from .comm import all_gather_tiled, all_reduce_sum
from .mesh import AXIS_DATA, Mesh


def _gather_shards(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[dp, ...]: every data shard's ``x`` (bool travels as uint8)."""
    flat = all_gather_tiled(x.to(torch.int64)[None] if x.dtype == torch.bool
                            else x[None], mesh, AXIS_DATA)
    return flat.to(torch.bool) if x.dtype == torch.bool else flat


@dataclasses.dataclass
class ShardedIndex:
    """This rank's sorted shard of a kmer column, on the mesh's device.

    key/length/row_ids: the shard's rows sorted by (key, length), padding
    last (row id -1); live: the shard's real rows; n: the column's rows;
    zero_rows: the row ids of empty kmers (a zero-length pattern's
    answer).
    """

    key: torch.Tensor
    length: torch.Tensor
    row_ids: torch.Tensor
    live: int
    mesh: Mesh
    n: int
    zero_rows: np.ndarray

    @classmethod
    def build(cls, column: PackedKmers, mesh: Mesh) -> "ShardedIndex":
        ndev = mesh.n_parts
        dp = mesh.shape[0]
        key = key_from_hi_lo(column.hi, column.lo).ravel()
        ln = np.asarray(column.length, np.int32).ravel()
        n = key.size
        pad = (-n) % ndev if n else ndev
        key = np.pad(key, (0, pad), constant_values=SENTINEL_KEY)
        ln = np.pad(ln, (0, pad), constant_values=int(SENTINEL_LEN))
        rid = np.pad(np.arange(n, dtype=np.int64), (0, pad),
                     constant_values=-1)
        n_loc = key.size // dp
        d = mesh.coords[0]
        at = slice(d * n_loc, (d + 1) * n_loc)
        dev = mesh.device
        col = KmerColumn(key=torch.from_numpy(key[at]).to(dev),
                         length=torch.from_numpy(ln[at]).to(dev))
        scol, order = device_sort_column(col)
        live = int((scol.length != int(SENTINEL_LEN)).sum())
        return cls(key=scol.key, length=scol.length,
                   row_ids=torch.from_numpy(rid[at]).to(dev)[order],
                   live=live, mesh=mesh, n=n,
                   zero_rows=np.flatnonzero(ln[:n] == 0))

    def __len__(self) -> int:
        return self.n

    @property
    def shard_rows(self) -> int:
        """Rows held by each data shard (padding included)."""
        return int(self.key.numel())

    def _query_batch(self, kmers) -> KmerColumn:
        pk = PackedKmers.from_strings([str(Kmer(s)) for s in kmers])
        return KmerColumn.from_packed(pk, self.mesh.device)

    def _lookup(self, op: str, kmers, cap: int):
        """(sorted row ids per query, exact global counts [M]); raises
        OverflowError where a shard's hits passed ``cap``."""
        if op not in ("eq", "prefix"):
            raise ValueError(f"unknown sharded lookup op {op!r}")
        cap = ladder_cap(cap, self.shard_rows)
        q = self._query_batch(kmers)
        rows, hit, count = self.lookup(op, q.key, q.length, cap)
        rows, hit, count = rows.cpu().numpy(), hit.cpu().numpy(), \
            count.cpu().numpy()
        out = []
        for j in range(rows.shape[1]):
            r = rows[:, j][hit[:, j]]
            if r.size < count[j]:
                raise OverflowError(
                    f"sharded lookup cap {cap} truncated a shard's hits for "
                    f"query {j} ({count[j]} total); re-query with cap >= "
                    f"{int(count[j])}")
            out.append(np.sort(r))
        return out, count

    def lookup(self, op: str, qkey: torch.Tensor, qln: torch.Tensor,
               cap: int):
        """The device step: (rows [dp, M, cap] global row ids, -1 padded;
        hit [dp, M, cap]; count [M] exact hits over the shards, summed over
        "data" even where cap cut the rows)."""
        live = self.live
        left = searchsorted_packed(self.key, self.length, qkey, qln, "left")
        if op == "eq":
            right = searchsorted_packed(self.key, self.length, qkey, qln,
                                        "right")
        else:
            ukey, wrapped = prefix_upper_key(qkey, qln)
            right = searchsorted_packed(self.key, self.length, ukey,
                                        torch.full_like(qln, -1), "left")
            right = torch.where(wrapped, live, right)
            empty = qln == 0  # the empty prefix matches every live row
            left = torch.where(empty, 0, left)
            right = torch.where(empty, live, right)
        left = left.clamp(max=live)
        right = right.clamp(max=live)
        offs = torch.arange(cap, dtype=torch.int64, device=left.device)
        pos = left[:, None] + offs[None, :]
        hit = pos < right[:, None]
        rows = self.row_ids[pos.clamp(0, max(self.shard_rows - 1, 0))]
        rows = torch.where(hit, rows, -1)
        count = all_reduce_sum(right - left, self.mesh, AXIS_DATA)
        return (_gather_shards(rows, self.mesh),
                _gather_shards(hit, self.mesh), count)

    # -- host conveniences (exact; the cap grows on truncation) -------------

    def search_eq(self, kmers, cap: int = 32) -> list[np.ndarray]:
        """Global row ids per query kmer (strategy 3), over every shard."""
        return self._auto("eq", kmers, cap)

    def search_prefix(self, prefixes, cap: int = 128) -> list[np.ndarray]:
        """Global row ids per prefix (strategy 28)."""
        return self._auto("prefix", prefixes, cap)

    def search_pattern(self, qkmers, cap: int = 128) -> list[np.ndarray]:
        """Global row ids per qkmer pattern (strategies 7/8), exact by cap
        regrowth, grouped by pattern length."""
        view = DeviceIndex(key=self.key, length=self.length,
                           row_ids=self.row_ids)

        def group_fn(qlen, masks, c):
            # padding rows can never match: their length is SENTINEL_LEN
            rows, hit, trunc = view.pattern_hits(masks, qlen=qlen, cap=c)
            rows = _gather_shards(rows, self.mesh).cpu().numpy()
            hit = _gather_shards(hit, self.mesh).cpu().numpy()
            trunc = all_reduce_sum(trunc.to(torch.int64), self.mesh,
                                   AXIS_DATA)
            return ([np.sort(rows[:, j][hit[:, j]])
                     for j in range(rows.shape[1])], bool(trunc.any()))

        return pattern_search_grouped(qkmers, self.zero_rows, group_fn, cap,
                                      cap_limit=self.shard_rows)

    def _auto(self, op, kmers, cap):
        while True:
            try:
                return self._lookup(op, kmers, cap)[0]
            except OverflowError:
                cap *= 4
                if cap >= self.shard_rows:
                    # a cap of a whole shard cannot truncate
                    return self._lookup(op, kmers, self.shard_rows)[0]
