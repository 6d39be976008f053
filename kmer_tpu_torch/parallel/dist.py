"""Sharded extraction and counting over a ("data", "seq") mesh of ranks.

The counterpart of ``kmer_tpu/parallel/dist.py``.  Each rank takes its
block of a global read batch (rows over "data", bases over "seq"),
extracts its windows with a k-1 halo from the next seq rank, counts them
with the sort and the segment-count kernel, and the ranks merge their
tables with collectives:

* ``merge="gather"``: every rank's table (one slot per window slot) is
  all-gathered and recounted; every rank holds the whole table.
* ``merge="partition"``: each rank routes its live groups to rank
  ``hash(key) % n_parts`` through fixed ``[n_parts, cap]`` slabs (a sort
  by bucket, searchsorted offsets and gathers; no scatter), one
  all_to_all swaps them, and a recount gives each rank a disjoint hash
  range of the table.  A bucket past ``cap`` loses its tail, counted in
  the overflow, which callers must check.

Where ``kmer_tpu``'s single controller maps a function over its devices,
here every rank runs these functions on the same global inputs (every
rank of a test builds them from one seed) and keeps its own block.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.codes_keys import as_codes, codes_keys
from ..kernels.wire_keys import wire_keys
from ..ops.count import (
    SENTINEL_KEY, SENTINEL_LEN, CountTable, count_packed, count_windows)
from ..ops.predicates import hash_u32
from .comm import all_gather_tiled, all_reduce_sum, all_to_all_slabs, ring_shift
from .mesh import Mesh

_LOW32 = 0xFFFFFFFF


def _rows_cols(mesh: Mesh, n_rows: int, n_cols: int) -> tuple[slice, slice]:
    """This rank's (rows, columns) block of a global [n_rows, n_cols]
    batch: rows shard over "data", columns over "seq"."""
    dp, sp = mesh.shape
    if n_rows % dp or n_cols % sp:
        raise ValueError(
            f"a [{n_rows}, {n_cols}] batch does not shard evenly over "
            f"mesh {mesh.shape}")
    d, s = mesh.coords
    b, c = n_rows // dp, n_cols // sp
    return slice(d * b, (d + 1) * b), slice(s * c, (s + 1) * c)


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint32:
            x = x.view(np.int32)
        elif x.dtype == np.uint16:
            x = x.astype(np.int32)
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def local_block(codes, lengths, mesh: Mesh
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's (codes [b_loc, l_loc], lengths [b_loc]) of a global
    batch (numpy or tensors), on the mesh's device.  Lengths stay the
    reads' full lengths."""
    rows, cols = _rows_cols(mesh, codes.shape[0], codes.shape[1])
    return (_to_device(codes[rows, cols], mesh.device),
            _to_device(lengths[rows], mesh.device))


def _local_lengths(lengths_l: torch.Tensor, mesh: Mesh, l_loc: int,
                   k: int) -> torch.Tensor:
    """A read's bases from this rank's first column on, clamped to the
    ``l_loc + k - 1`` bases of the halo'd row: window i of the row is
    valid iff ``i <= that - k``, which is ``s * l_loc + i <= len - k``."""
    s = mesh.coords[1]
    return (lengths_l.to(torch.int64) - s * l_loc).clamp(0, l_loc + k - 1)


def _check_halo(mesh: Mesh, l_loc: int, k: int) -> None:
    if mesh.shape[1] > 1 and k - 1 > l_loc:
        raise ValueError(
            f"a k-1 = {k - 1} base halo needs seq blocks of at least k-1 "
            f"bases; this mesh gives {l_loc}")


def _extract_with_halo(codes_l: torch.Tensor, lengths_l: torch.Tensor,
                       k: int, mesh: Mesh, canonical: bool
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Keys and valid mask [b_loc, l_loc] of the windows that start in
    this rank's block of bases.  They need the first k-1 bases of the
    next seq rank (the ring halo; on one seq rank, zeros, as windows past
    a read's end are invalid anyway).  One ``codes_keys`` launch over the
    halo'd rows, whose clamped lengths make its own rule
    ``i <= length - k`` this mask."""
    b_loc, l_loc = codes_l.shape
    _check_halo(mesh, l_loc, k)
    ext = as_codes(codes_l)
    if k > 1:
        head = ext[:, : k - 1]
        halo = (ring_shift(head, mesh) if mesh.shape[1] > 1
                else torch.zeros_like(head))
        ext = torch.cat([ext, halo], dim=1)
    return codes_keys(ext, _local_lengths(lengths_l, mesh, l_loc, k), k,
                      canonical)


def _wire_keys_with_halo(words_l: torch.Tensor, lengths_l: torch.Tensor,
                         k: int, mesh: Mesh, canonical: bool
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed-wire form of ``_extract_with_halo``: one ``wire_keys``
    launch over rows of this rank's words, the next seq rank's first
    ceil((k-1)/16) words and the clamped length column (width
    ``l_loc + k - 1``).  The kernel's own rule ``i <= length - k`` is then
    the mask of ``_extract_with_halo``.  words_l: [b_loc, l_loc/16] int32
    (uint32 bits)."""
    b_loc, nw_loc = words_l.shape
    l_loc = 16 * nw_loc
    _check_halo(mesh, l_loc, k)
    hw = -(-(k - 1) // 16)
    parts = [words_l]
    if hw:
        head = words_l[:, :hw]
        parts.append(ring_shift(head, mesh) if mesh.shape[1] > 1
                     else torch.zeros_like(head))
    lens = _local_lengths(lengths_l, mesh, l_loc, k).to(torch.int32)
    wire = torch.cat(parts + [lens[:, None]], dim=1).contiguous()
    return wire_keys(wire, l_loc + k - 1, k, canonical)


def _bucket_of(keys: torch.Tensor, length: torch.Tensor,
               n_parts: int) -> torch.Tensor:
    """Hash bucket in [0, n_parts) of each (key, length): the hash index's
    murmur finalizer (``ops.predicates.hash_u32``), bit-equal to
    ``kmer_tpu``'s, so equal keys route to the same rank in both."""
    return hash_u32(keys, length) % n_parts


def _pack_rows(keys, length, counts) -> torch.Tensor:
    """(key, length, count) rows as one int64 [n, 2] slab: the key, and
    the length in the high word beside the count in the low one."""
    meta = (length.to(torch.int64) << 32) | (counts.to(torch.int64) & _LOW32)
    return torch.stack([keys, meta], dim=-1)


def _unpack_rows(rows: torch.Tensor):
    rows = rows.reshape(-1, 2)
    return rows[:, 0], rows[:, 1] >> 32, rows[:, 1] & _LOW32


def _partition_merge_local(table: CountTable, n_parts: int, cap: int,
                           mesh: Mesh) -> tuple[CountTable, torch.Tensor]:
    """all_to_all merge of this rank's sorted-run table.

    1. sort the slots by bucket (dead slots, bucket n_parts, last);
    2. bucket offsets by searchsorted over the sorted buckets;
    3. send slot (b, w) reads sorted position offsets[b] + w (a gather),
       sentinel-padded past the bucket's size;
    4. one all_to_all swaps bucket b to rank b;
    5. a weighted recount of what arrived.

    Returns (this rank's shard of the table, this rank's overflow: the
    slots its buckets lost past ``cap``, an int64 0-dim tensor).  The
    callers sum the overflow over the mesh.
    """
    keys, length, counts = table.keys, table.length, table.counts
    if keys.numel() == 0:  # k = 32 with no valid window: one dead slot
        keys = torch.full((1,), SENTINEL_KEY, device=keys.device)
        length = torch.full((1,), int(SENTINEL_LEN), dtype=torch.int32,
                            device=keys.device)
        counts = torch.zeros(1, dtype=torch.int32, device=keys.device)
    n = keys.numel()
    dev = keys.device
    bucket = torch.where(counts > 0, _bucket_of(keys, length, n_parts),
                         n_parts)
    sb, order = torch.sort(bucket, stable=True)
    offsets = torch.searchsorted(
        sb, torch.arange(n_parts + 1, dtype=sb.dtype, device=dev))
    per_bucket = offsets[1:] - offsets[:-1]
    overflow = (per_bucket - cap).clamp(min=0).sum()
    w = torch.arange(cap, dtype=torch.int64, device=dev)[None, :]
    src = order[(offsets[:-1, None] + w).clamp(0, n - 1)]  # [n_parts, cap]
    live = w < per_bucket[:, None]
    send = _pack_rows(
        torch.where(live, keys[src], SENTINEL_KEY),
        torch.where(live, length[src], int(SENTINEL_LEN)),
        torch.where(live, counts[src], 0))
    rkeys, rlen, rcounts = _unpack_rows(all_to_all_slabs(send, mesh))
    return count_packed(rkeys, rlen, rcounts), overflow


def _pad_table(table: CountTable, slots: int) -> CountTable:
    """A table grown to ``slots`` slots with dead ones (the k = 32 table
    holds only the valid windows; the gather sends one slot per window
    slot on every rank)."""
    pad = slots - table.capacity
    if pad <= 0:
        return table
    dev = table.keys.device
    return dataclasses.replace(
        table,
        keys=torch.cat([table.keys, torch.full((pad,), SENTINEL_KEY,
                                               device=dev)]),
        length=torch.cat([table.length, torch.full(
            (pad,), int(SENTINEL_LEN), dtype=torch.int32, device=dev)]),
        counts=torch.cat([table.counts, torch.zeros(
            pad, dtype=torch.int32, device=dev)]))


def bucket_cap(slots: int, n_parts: int, slack: float) -> int:
    """Slots of each partition bucket: ``slack`` times a fair share of the
    rank's window slots (not its valid windows, as in ``kmer_tpu``)."""
    return max(8, int(slack * slots / n_parts + 1))


def make_sharded_count_step(mesh: Mesh, k: int, canonical: bool = False,
                            merge: str = "gather", slack: float = 2.0):
    """The multi-rank counting step.

    Returns step(codes [B, L], lengths [B]) -> CountTable for
    merge="gather" (the whole table on every rank), or (CountTable,
    overflow) for merge="partition" (this rank's disjoint hash range;
    overflow an int64 0-dim tensor summed over the mesh, which must be 0
    for the result to be exact).  ``n_unique`` is the mesh's total either
    way.  B shards over "data", L over "seq"; every rank is given the
    whole batch.
    """
    if merge not in ("gather", "partition"):
        raise ValueError(f"unknown merge strategy {merge!r}")
    n_parts = mesh.n_parts

    def step(codes, lengths):
        codes_l, lengths_l = local_block(codes, lengths, mesh)
        keys, valid = _extract_with_halo(codes_l, lengths_l, k, mesh,
                                         canonical)
        slots = keys.numel()
        table = count_windows(keys, valid, k)
        if merge == "partition":
            shard, overflow = _partition_merge_local(
                table, n_parts, bucket_cap(slots, n_parts, slack), mesh)
            total = all_reduce_sum(torch.stack([
                shard.n_unique.to(torch.int64), overflow]), mesh)
            return (dataclasses.replace(shard,
                                        n_unique=total[0].to(torch.int32)),
                    total[1])
        table = _pad_table(table, slots)
        rows = all_gather_tiled(
            _pack_rows(table.keys, table.length, table.counts), mesh)
        return count_packed(*_unpack_rows(rows))

    return step


def merge_efficiency(table: CountTable, n_devices: int,
                     merge: str = "gather", slack: float = 2.0, *,
                     slots: int | None = None) -> dict:
    """Merge-efficiency stats of a rank's local table (BASELINE metric 3):
    useful payload bytes over the bytes this rank's merge puts on the
    interconnect, 16 a slot as in ``kmer_tpu``.

    * gather: every slot of the table travels, live or not;
    * partition: n_devices buckets of ``cap`` slots travel once.

    ``slots``: the window slots the table was counted from (default its
    capacity).  The port's k = 32 table holds only the valid windows, so
    pass the slot count there to get ``kmer_tpu``'s figures.
    """
    capacity = int(table.capacity if slots is None else slots)
    live = int((table.counts > 0).sum())
    entry_bytes = 16
    useful = live * entry_bytes
    if merge == "gather":
        sent = capacity * entry_bytes
    elif merge == "partition":
        sent = n_devices * bucket_cap(capacity, n_devices, slack) * entry_bytes
    else:
        raise ValueError(f"unknown merge strategy {merge!r}")
    return {
        "merge": merge,
        "n_devices": n_devices,
        "live_groups": live,
        "capacity": capacity,
        "bytes_sent_per_device": sent,
        "useful_bytes": useful,
        "efficiency": (useful / sent) if sent else 1.0,
    }


def count_kmers_sharded(codes, lengths, k: int, mesh: Mesh,
                        canonical: bool = False, merge: str = "gather"
                        ) -> CountTable:
    """One sharded count.  merge="partition" reads the overflow on the
    host and, if any bucket overflowed, counts again with the gather
    merge, so the result is always exact (this rank's hash range, or the
    whole table after a gather)."""
    step = make_sharded_count_step(mesh, k, canonical, merge=merge)
    if merge == "partition":
        table, overflow = step(codes, lengths)
        if int(overflow) == 0:
            return table
        step = make_sharded_count_step(mesh, k, canonical, merge="gather")
    return step(codes, lengths)
