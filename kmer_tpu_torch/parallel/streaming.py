"""The sharded stream, wide-accumulator snapshots and overlapped
checkpoint writes.

The counterpart of ``kmer_tpu/parallel/streaming.py``.  Each step of
``stream_sharded_count`` extracts and counts one global read batch over
the mesh, hash-partitions the ranks' tables with one all_to_all
(``dist._partition_merge_local``) and folds each rank's share into its
own 64-bit ``WideCounts``: every rank owns a disjoint hash range, so the
fold is rank-local.  On one rank the windows fold straight into the
accumulator (``fold_windows_into_wide``).  ``save_wide``/``load_wide``
write and read the same npz layout as ``kmer_tpu``, so a table or
checkpoint saved by one package loads, and resumes, in the other;
``AsyncCheckpointer`` overlaps a write with the count.

Layout (format v2): the live rows' ``hi``/``lo`` uint32, ``length``
int32, ``counts_hi`` int32 and ``counts_lo`` uint32 (the 64-bit count
split), ``live_per_shard`` int64 [shards], ``shard_cap``, ``n_unique``
and ``meta``, a JSON string with ``"version": 2``.  Each shard's live
rows come back at the front of that shard.  Format v1 files (full-capacity
lanes) are read too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from ..ops.count import SENTINEL, SENTINEL_LEN, count_windows
from ..ops.wide import WideCounts, fold_windows_into_wide, merge_into_wide
from ..utils.logging import StatsCounters, get_logger
from .comm import all_gather_tiled, all_reduce_sum
from .dist import (
    _extract_with_halo, _partition_merge_local, _rows_cols, _to_device,
    _wire_keys_with_halo, bucket_cap, local_block)
from .mesh import Mesh

_CKPT_VERSION = 2


def _lanes(keys: torch.Tensor, length: torch.Tensor, counts: torch.Tensor
           ) -> np.ndarray:
    """Rows' five ``kmer_tpu`` lanes (hi, lo, length, counts_hi,
    counts_lo) as one [5, n] int32 host array, built on the rows' device
    from the int64 lanes' 32-bit halves and copied to the host once."""
    k32 = keys.contiguous().view(torch.int32).reshape(-1, 2)  # (low, high)
    c32 = counts.contiguous().view(torch.int32).reshape(-1, 2)
    return torch.stack([k32[:, 1], k32[:, 0], length.to(torch.int32),
                        c32[:, 1], c32[:, 0]]).cpu().numpy()


def _live_lanes(acc: WideCounts) -> np.ndarray:
    """The live rows' five lanes (``_lanes``)."""
    live = acc.counts > 0
    if acc.counts.device.type == "cpu" and bool(live.all()):
        return _lanes(acc.keys, acc.length, acc.counts)
    idx = torch.nonzero(live).squeeze(1)
    return _lanes(acc.keys[idx], acc.length[idx], acc.counts[idx])


def _write_v2(path: str, lanes: np.ndarray, live_per_shard, shard_cap: int,
              n_unique: int, meta: dict | None, compress: bool) -> None:
    """Write the v2 layout atomically: ``lanes`` are every shard's live
    rows in shard order (``_lanes``)."""
    from ..utils.checkpoint import atomic_savez

    atomic_savez(
        path, compress=compress,
        hi=lanes[0].view(np.uint32), lo=lanes[1].view(np.uint32),
        length=lanes[2], counts_hi=lanes[3],
        counts_lo=lanes[4].view(np.uint32),
        live_per_shard=np.asarray(live_per_shard, np.int64),
        shard_cap=np.int64(shard_cap),
        n_unique=np.int64(n_unique),
        meta=json.dumps({"version": _CKPT_VERSION, **(meta or {})}),
    )


def save_wide(acc: WideCounts, path: str, meta: dict | None = None,
              compress: bool = True) -> None:
    """Snapshot a wide accumulator's live rows (one shard) to npz,
    atomically; ``compress=False`` skips zlib (checkpoints of many rows)."""
    lanes = _live_lanes(acc)
    _write_v2(path, lanes, [lanes.shape[1]], acc.capacity, acc.n_unique,
              meta, compress)


def _read_snapshot(path: str):
    """(meta, the five lanes as stored, the file's names), validated."""
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
        extra = {name: z[name] for name in
                 ("live_per_shard", "shard_cap", "n_unique")
                 if name in z.files}
    return meta, lanes, extra


def load_live(path: str) -> tuple[WideCounts, dict]:
    """(the live rows of a snapshot written by either package, in file
    order, as a host table whose ``n_unique`` is their number; meta).
    Unlike ``load_wide`` nothing is padded back to capacity: a rank file
    or a one-shard checkpoint is its live rows in key order."""
    meta, lanes, _ = _read_snapshot(path)
    acc = WideCounts.from_numpy(*lanes)
    return (acc if bool((acc.counts > 0).all()) else acc.trim()), meta


def load_wide(path: str) -> tuple[WideCounts, dict]:
    """(host WideCounts, meta) from a snapshot written by either package;
    each shard's live rows come back at the front of its slots."""
    meta, lanes, extra = _read_snapshot(path)
    if "live_per_shard" in extra:  # compact: pad each shard back
        lps = np.asarray(extra["live_per_shard"], np.int64)
        shard_cap = int(extra["shard_cap"])
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
    acc = WideCounts.from_numpy(*lanes, n_unique=int(extra["n_unique"]))
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


# --- the sharded stream ------------------------------------------------------


def make_sharded_stream_step(mesh: Mesh, k: int, canonical: bool = False,
                             acc_capacity: int = 1 << 16, slack: float = 2.0,
                             packed_width: int | None = None):
    """The accumulation step over a mesh.

    step(acc, overflow, codes [B, L], lengths [B]) -> (acc', overflow'):
    ``acc`` is this rank's WideCounts of ``acc_capacity`` slots, the keys
    that hash to its rank (its ``n_unique`` is its own distinct count),
    and ``overflow`` an int64 0-dim tensor on the mesh's device: the
    running total, over the mesh, of (a) bucket clips of the all_to_all
    and (b) accumulator-capacity misses.  Every rank holds the same
    value; the result is exact iff the final overflow is 0.  Every rank
    is given the whole batch and takes its block; ``step.local`` takes
    the rank's block alone (its rows, and its columns of them).

    ``packed_width``: batches arrive as the 2-bit wire, [B,
    packed_width/16] uint32 words and lengths [B], and each rank's block
    becomes keys in one ``wire_keys`` launch; packed_width must be a
    multiple of 16 * seq so the word axis shards evenly.
    """
    sp = mesh.shape[1]
    n_parts = mesh.n_parts
    if packed_width is not None and packed_width % (16 * sp):
        raise ValueError(
            f"packed_width {packed_width} must be a multiple of 16*seq "
            f"({16 * sp})")

    def local_step(acc: WideCounts, overflow: torch.Tensor, codes_l, lengths_l):
        if packed_width is not None:
            keys, valid = _wire_keys_with_halo(codes_l, lengths_l, k, mesh,
                                               canonical)
        else:
            keys, valid = _extract_with_halo(codes_l, lengths_l, k, mesh,
                                             canonical)
        if n_parts == 1:
            # one rank owns the whole hash range: no routing, and the
            # batch's windows fold straight into the accumulator
            acc2 = fold_windows_into_wide(acc, keys, valid, k)
            miss = torch.zeros((), dtype=torch.int64, device=keys.device)
        else:
            table = count_windows(keys, valid, k)
            cap = bucket_cap(keys.numel(), n_parts, slack)
            # merge efficiency (BASELINE metric 3): live groups sent, and
            # the slots sent, summed over the steps; read at the end
            local_step.live_sent = local_step.live_sent + (
                table.counts > 0).sum()
            local_step.slots_sent += n_parts * cap
            shard, miss = _partition_merge_local(table, n_parts, cap, mesh)
            acc2 = merge_into_wide(acc, shard)
        miss = miss + max(acc2.n_unique - acc_capacity, 0)
        return acc2, overflow + all_reduce_sum(miss, mesh)

    def step(acc: WideCounts, overflow: torch.Tensor, codes, lengths):
        if packed_width is None:
            return local_step(acc, overflow, *local_block(codes, lengths,
                                                          mesh))
        if codes.shape[1] != packed_width // 16:
            raise ValueError(
                f"a packed batch of width {packed_width} has "
                f"{packed_width // 16} words a row, got {codes.shape[1]}")
        rows, cols = _rows_cols(mesh, codes.shape[0], codes.shape[1])
        return local_step(acc, overflow,
                          _to_device(codes[rows, cols], mesh.device),
                          _to_device(lengths[rows], mesh.device))

    local_step.live_sent = 0
    local_step.slots_sent = 0
    step.local = local_step  # the same step on this rank's block alone
    return step


def empty_sharded_acc(mesh: Mesh, acc_capacity: int = 1 << 16) -> WideCounts:
    """This rank's all-sentinel accumulator shard (``acc_capacity``
    slots) on the mesh's device."""
    return WideCounts.empty(acc_capacity, mesh.device)


class _StreamSnapshotter:
    """Checkpoint snapshots of a sharded accumulator, written as one file.

    ``snapshot`` runs on the main loop of every rank at the same batch (it
    is collective): the ranks' live rows and distinct counts are
    all-gathered on the device, each rank's rows padded to the largest
    rank's live count.  ``write`` runs on the writer thread: rank 0 moves
    the rows to the host and writes ``kmer_tpu``'s v2 layout (shard r's
    live rows in rank order, ``live_per_shard``, ``shard_cap``), so the
    file resumes in either package.  The other ranks write nothing.
    """

    def __init__(self, mesh: Mesh, shard_cap: int):
        self.mesh = mesh
        self.shard_cap = shard_cap
        self.last_cost_s = 0.0  # the last write's transfer + file time
        self.last_max_live = 0  # the largest shard's live rows then

    def snapshot(self, acc: WideCounts) -> dict:
        idx = torch.nonzero(acc.counts > 0).squeeze(1)
        dev = acc.keys.device
        sizes = all_gather_tiled(torch.tensor(
            [[idx.numel(), acc.n_unique]], dtype=torch.int64, device=dev),
            self.mesh).cpu()
        mx = int(sizes[:, 0].max())
        rows = torch.zeros((mx, 3), dtype=torch.int64, device=dev)
        rows[: idx.numel()] = torch.stack([
            acc.keys[idx], acc.length[idx].to(torch.int64), acc.counts[idx]],
            dim=1)
        return {"rows": all_gather_tiled(rows, self.mesh), "max_live": mx,
                "live_per_shard": sizes[:, 0].numpy(),
                "n_unique": int(sizes[:, 1].sum())}

    def write(self, snap: dict, path: str, meta: dict | None = None) -> None:
        self.last_max_live = snap["max_live"]
        if self.mesh.rank != 0:
            return
        t0 = time.perf_counter()
        lps = snap["live_per_shard"].astype(np.int64)
        mx = snap["max_live"]
        host = snap["rows"].cpu().reshape(lps.size, mx, 3)
        rows = host[torch.arange(mx)[None, :] < torch.from_numpy(lps)[:, None]]
        _write_v2(path, _lanes(rows[:, 0], rows[:, 1], rows[:, 2]), lps,
                  self.shard_cap, snap["n_unique"], meta, compress=False)
        self.last_cost_s = time.perf_counter() - t0


def check_resume_meta(meta: dict, path: str, **want) -> None:
    """Refuse a checkpoint written with other settings: a resume that
    folds other windows (k, canonical) or skips another number of reads
    (batch, width) would be silently wrong.  A key the checkpoint does not
    record (``kmer_tpu`` writes none of these) is not checked."""
    for name, value in want.items():
        have = meta.get(name)
        if have is not None and value is not None and have != value:
            raise ValueError(
                f"checkpoint {path} was written with {name}={have}; this "
                f"run uses {name}={value}")


class ResumableStream:
    """Checkpoint/resume state of ``stream_sharded_count``.

    The file holds every rank's shard in rank order, the batches done and
    the mesh shape (and, written by the port, k, canonical and the batch
    shape): a resume needs the same mesh, as keys are placed by hash %
    ranks.  Every rank opens the same path; rank 0 writes it.
    """

    def __init__(self, path: str):
        self.path = path
        self.acc: WideCounts | None = None  # every shard, on the host
        self.meta: dict = {}
        self.batches_done = 0
        self.overflow = 0
        self.mesh_shape: tuple[int, int] | None = None
        self.n_checkpoints = 0  # written by this process
        self.ckpt_wait_s = 0.0  # main-loop stall on checkpoint joins
        if os.path.exists(path):
            self.acc, self.meta = load_wide(path)
            self.batches_done = int(self.meta.get("batches_done", 0))
            self.overflow = int(self.meta.get("overflow", 0))
            self.mesh_shape = tuple(self.meta.get("mesh_shape", ())) or None

    def shard(self, rank: int, shard_cap: int) -> WideCounts:
        """Rank ``rank``'s slots of the loaded accumulator."""
        at = slice(rank * shard_cap, (rank + 1) * shard_cap)
        counts = self.acc.counts[at]
        return WideCounts(keys=self.acc.keys[at], length=self.acc.length[at],
                          counts=counts, n_unique=int((counts > 0).sum()))

    def checkpoint_snapshot(self, snapper: _StreamSnapshotter, snap: dict,
                            batches_done: int, overflow: int,
                            mesh_shape: tuple[int, int], **meta) -> None:
        """Write a snapshot (writer-thread side)."""
        snapper.write(snap, self.path, {
            "batches_done": batches_done, "overflow": overflow,
            "mesh_shape": list(mesh_shape), **meta})
        self.batches_done = batches_done
        self.n_checkpoints += 1


def stream_sharded_count(
    batches: Iterable[tuple[np.ndarray, np.ndarray]],
    k: int,
    mesh: Mesh,
    canonical: bool = False,
    acc_capacity: int = 1 << 16,
    slack: float = 2.0,
    resumable: ResumableStream | None = None,
    ckpt_every: int = 16,
    stats: StatsCounters | None = None,
    warmup: tuple | None = None,
    ckpt_target_overhead: float | None = None,
) -> tuple[WideCounts, int]:
    """Stream global (codes [B, L], lengths [B]) batches into a sharded
    count; every rank is given every batch.

    Returns (this rank's accumulator shard, whose ``n_unique`` is the
    mesh's total, overflow).  overflow > 0 means some keys were clipped:
    raise acc_capacity or slack and run again.  All batches share one
    shape.  ``warmup``: one (codes, lengths) batch stepped once on a
    scratch accumulator first, which loads the kernels outside the
    stream.  ``ckpt_target_overhead`` (e.g. 0.1): a checkpoint
    opportunity (every ``ckpt_every`` batches) is skipped while the time
    since the last checkpoint is under ``last_write_time * (1/target -
    1)``; rank 0's clock decides for every rank.  The first opportunity
    always fires.
    """
    log = get_logger()
    mesh_shape = tuple(mesh.shape)
    step = make_sharded_stream_step(mesh, k, canonical, acc_capacity, slack)
    snapper = _StreamSnapshotter(mesh, acc_capacity)
    zero = torch.zeros((), dtype=torch.int64, device=mesh.device)
    if warmup is not None:
        step(empty_sharded_acc(mesh, acc_capacity), zero, *warmup)
        log.info("stream step warmed up")

    start = 0
    overflow = zero
    acc = empty_sharded_acc(mesh, acc_capacity)
    if resumable is not None and resumable.acc is not None:
        if resumable.mesh_shape != mesh_shape:
            raise ValueError(f"checkpoint mesh {resumable.mesh_shape} != "
                             f"current {mesh_shape}")
        check_resume_meta(resumable.meta, resumable.path, k=k,
                          canonical=bool(canonical))
        acc = resumable.shard(mesh.rank, acc_capacity).to(mesh.device)
        start = resumable.batches_done
        overflow = zero + resumable.overflow

    settings = {"k": k, "canonical": bool(canonical)}

    def _write(snap, done_, ovf_):
        # int(ovf_) reads the device here, on the writer thread
        resumable.checkpoint_snapshot(snapper, snap, done_, int(ovf_),
                                      mesh_shape, **settings)

    writer = AsyncCheckpointer(_write) if resumable is not None else None
    last_ckpt_t = float("-inf")
    done = 0
    try:
        for i, (codes, lengths) in enumerate(batches):
            if i < start:
                continue
            acc, overflow = step(acc, overflow, codes, lengths)
            done = i + 1
            if stats is not None:
                ls = np.asarray(lengths, np.int64)
                stats.record_batch(int((ls > 0).sum()), int(ls.sum()),
                                   int(np.maximum(ls - (k - 1), 0).sum()), 0)
            if writer is None or done % ckpt_every:
                continue
            if ckpt_target_overhead is not None:
                cost = snapper.last_cost_s or writer.last_write_s
                gap = cost * (1.0 / ckpt_target_overhead - 1.0)
                take = (mesh.rank == 0
                        and time.perf_counter() - last_ckpt_t >= gap)
                if not int(all_reduce_sum(torch.tensor(
                        int(take), device=mesh.device), mesh)):
                    continue
                last_ckpt_t = time.perf_counter()
            writer.submit(snapper.snapshot(acc), done, overflow)
            log.info("checkpoint %d submitted", done)
    finally:
        if writer is not None:
            writer.close()
    if done == 0 and start == 0:
        raise ValueError("empty batch stream")
    if writer is not None:
        resumable.ckpt_wait_s += writer.wait_s
        if done > resumable.batches_done:
            _write(snapper.snapshot(acc), done, overflow)
    n_unique = all_reduce_sum(torch.tensor(acc.n_unique, device=mesh.device),
                              mesh)
    return dataclasses.replace(acc, n_unique=int(n_unique)), int(overflow)


def batches_of(codes: np.ndarray, lengths: np.ndarray, batch: int
               ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """One big [N, L] read array as fixed [batch, L] steps (the tail padded
    with zero-length reads so every step has one shape)."""
    n = codes.shape[0]
    for s in range(0, n, batch):
        e = min(s + batch, n)
        if e - s == batch:
            yield codes[s:e], lengths[s:e]
        else:
            c = np.zeros((batch, codes.shape[1]), codes.dtype)
            ln = np.zeros((batch,), np.int32)
            c[: e - s] = codes[s:e]
            ln[: e - s] = lengths[s:e]
            yield c, ln
