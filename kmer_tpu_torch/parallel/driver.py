"""The distributed counting driver (``kmer_tpu_torch distcount``).

The counterpart of ``kmer_tpu/parallel/driver.py``.  Every rank runs

    python -m kmer_tpu_torch distcount --coordinator host:port \\
        --num-processes N --process-id i --input shard_i.fastq -k 21 \\
        --backend nccl|gloo --device cuda|cpu

which joins the process group (``initialize_multihost``), builds the pod
mesh, reads fixed-shape 2-bit-packed batches of its own input shard on a
producer thread, and folds them with the sharded stream step (a
``wire_keys`` launch a batch, the segment-count kernel, one all_to_all
hash-partition merge, a rank-local 64-bit accumulator), with per-rank
checkpoints, spills and result files ``<out>.rank{i}.npz``.  The union
of the rank tables (``merge_rank_files``) equals one process's count of
all the shards.

One process per rank replaces ``kmer_tpu``'s global arrays: each rank
feeds its own batch to the step, so ``put_global_batch``, ``local_wide``
and ``_global_from_local`` have no counterpart.  On a mesh with a seq
extent > 1, the ranks of one seq group read the same input and each
takes its block of every row's bases.
"""

from __future__ import annotations

import os
import time
from typing import Iterator

import numpy as np
import torch

from ..codec import MAX_K
from ..errors import InvalidKmerLengthError
from ..ops.wide import WideCounts, merge_runs, pad_wide
from ..utils.logging import StatsCounters, get_logger
from .comm import all_gather_tiled, all_reduce_sum
from .streaming import (
    AsyncCheckpointer, check_resume_meta, empty_sharded_acc, load_live,
    make_sharded_stream_step, save_wide)


def split_long_reads(
    codes: np.ndarray, offsets: np.ndarray, width: int, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Re-pack ragged reads into fixed-width rows, exactly.

    Reads longer than ``width`` split into consecutive pieces sharing a
    k-1 base overlap, so every window of the read appears in exactly one
    piece.  Reads shorter than k still get a row (with no windows).
    Returns (rows [n, width] uint8, lengths [n] int32).
    """
    if width <= k - 1:
        raise ValueError(f"width {width} must exceed k-1 = {k - 1}")
    lens = np.diff(offsets).astype(np.int64)
    step = width - (k - 1)
    # pieces per read: 1 + ceil(max(len - width, 0) / step)
    extra = np.maximum(lens - width, 0)
    n_pieces = 1 + -(-extra // step)
    total = int(n_pieces.sum())
    rows = np.zeros((total, width), np.uint8)
    read_of = np.repeat(np.arange(lens.size), n_pieces)
    first = np.concatenate([[0], np.cumsum(n_pieces)[:-1]])
    piece_idx = np.arange(total) - first[read_of]
    starts = offsets[:-1][read_of] + piece_idx * step
    plens = np.minimum(lens[read_of] - piece_idx * step, width)
    col = np.arange(width, dtype=np.int64)[None, :]
    if codes.size:
        idx = np.minimum(starts[:, None] + col, codes.size - 1)
        rows = np.where(col < plens[:, None], codes[idx], np.uint8(0))
    return rows, plens.astype(np.int32)


def file_batches_fixed(
    path: str, fmt: str, k: int, batch: int, width: int,
    chunk_bytes: int | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Fixed-shape [batch, width] raw-code batches of a FASTA/FASTQ file
    (the tail padded with zero-length reads); long reads split exactly.
    The file streams through record-aligned windows and each window is
    split on its own: reads are whole within a window, so the rows equal
    a whole-file split."""
    from ..io.ingest import DEFAULT_CHUNK_BYTES, iter_encoded_chunks
    from .streaming import batches_of

    if chunk_bytes is None:
        chunk_bytes = DEFAULT_CHUNK_BYTES
    buf_r: list[np.ndarray] = []
    buf_l: list[np.ndarray] = []
    pending = 0
    for codes, offs in iter_encoded_chunks(path, fmt, chunk_bytes):
        rows, lens = split_long_reads(codes, offs, width, k)
        buf_r.append(rows)
        buf_l.append(lens)
        pending += rows.shape[0]
        if pending >= batch:
            allr = np.concatenate(buf_r)
            alll = np.concatenate(buf_l)
            n_full = (pending // batch) * batch
            for s in range(0, n_full, batch):
                yield allr[s: s + batch], alll[s: s + batch]
            buf_r = [allr[n_full:]]
            buf_l = [alll[n_full:]]
            pending -= n_full
    if pending:
        yield from batches_of(np.concatenate(buf_r), np.concatenate(buf_l),
                              batch)


def _rank_path(path: str, pid: int) -> str:
    return f"{path}.rank{pid}.npz"


def _infer_fmt(path: str) -> str:
    low = path.lower()
    if low.endswith(".gz"):
        low = low[:-3]
    return "fastq" if low.endswith((".fastq", ".fq")) else "fasta"


def run_distcount(
    input_path: str,
    k: int,
    fmt: str | None = None,
    canonical: bool = False,
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    batch: int = 4096,
    width: int = 256,
    acc_capacity: int = 1 << 16,
    slack: float = 2.0,
    ckpt: str | None = None,
    ckpt_every: int = 16,
    out: str | None = None,
    mesh=None,
    stats: StatsCounters | None = None,
    chunk_bytes: int | None = None,
    spill_dir: str | None = None,
    spill_threshold: float = 0.85,
    *,
    device: str | torch.device,
    backend: str | None = None,
) -> tuple[WideCounts, int]:
    """Count this rank's input shard into its share of the global table.

    Returns (this rank's hash range of the table as a host WideCounts,
    whose ``n_unique`` is the mesh's total, and the overflow).  overflow
    > 0 means bucket or accumulator capacity clipped keys: run again with
    a larger ``acc_capacity`` or ``slack``.  With a coordinator, world
    size or rank given, the process group is initialized first on
    ``backend`` ("nccl" or "gloo"; required then) and ``device`` (a bare
    "cuda" is ``cuda:<local rank % cards>``).

    ``ckpt``: every ``ckpt_every`` batches each rank writes its shard to
    ``<ckpt>.rank{i}.npz`` on a writer thread, after copying the previous
    one to ``.prev``, so a kill at any moment leaves a whole generation.
    A resume refuses a checkpoint of another mesh, world size, k,
    canonical, batch or width; ranks whose checkpoints disagree on the
    batches done rewind to ``.prev``, or all fail together.
    ``spill_dir`` (needs ``ckpt``): at a checkpoint where the fullest
    rank's live slots pass ``spill_threshold * acc_capacity``, every rank
    flushes its live slots to a sorted run file and starts again empty;
    the result is the exact K-way merge of a rank's runs and its
    accumulator (ranks own disjoint hash ranges, so rank-local merging is
    exact).  The threshold must leave room for ``ckpt_every`` batches of
    new keys; an overflow that happens all the same is reported.
    """
    import torch.distributed as dist

    from .multihost import initialize_multihost, make_pod_mesh

    if not 1 <= k <= MAX_K:  # before any rank joins a process group
        raise InvalidKmerLengthError()
    log = get_logger()
    if any(x is not None for x in (coordinator, num_processes, process_id)):
        if backend is None:
            raise ValueError("initializing a process group needs an "
                             "explicit backend: 'nccl' or 'gloo'")
        initialize_multihost(coordinator_address=coordinator,
                             num_processes=num_processes,
                             process_id=process_id, backend=backend,
                             device=device)
    if mesh is None:
        mesh = make_pod_mesh(device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    pid = mesh.rank
    mesh_shape = tuple(mesh.shape)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    fmt = fmt or _infer_fmt(input_path)
    log.info("distcount rank %d/%d: mesh %s on %s, input %s (%s)", pid,
             world, mesh_shape, dev, input_path, fmt)

    # Feed: fixed-shape packed batches (pipeline.file_batch_feed) on a
    # producer thread.  Auto batch and width probe the file only in a
    # one-rank run: each rank would probe its own shard, and ranks must
    # agree on the step's shapes.
    from ..pipeline import _Feeder, _upload, file_batch_feed

    sp = mesh_shape[1]
    if world > 1:
        batch = batch or 65536
        width = width or 256
    feed, batch, width, _est = file_batch_feed(
        input_path, fmt, k, batch or None, width or None, chunk_bytes,
        width_multiple=16 * sp, target_windows=(1 << 26) // world)
    log.info("distcount feed: batch=%d width=%d (packed wire)", batch, width)
    step = make_sharded_stream_step(mesh, k, canonical, acc_capacity, slack,
                                    packed_width=width).local
    nw = width // 16
    s_idx = mesh.coords[1]
    cols = slice(s_idx * nw // sp, (s_idx + 1) * nw // sp)

    if spill_dir is not None:
        if not ckpt:
            raise ValueError("spill_dir requires checkpoints (ckpt)")
        os.makedirs(spill_dir, exist_ok=True)
    settings = {"k": k, "canonical": bool(canonical), "batch": batch,
                "width": width}
    rank_ckpt = _rank_path(ckpt, pid) if ckpt else None

    def _validated_load(path):
        local_acc, meta = load_live(path)
        if local_acc.capacity > acc_capacity:
            raise ValueError(
                f"checkpoint {path} holds {local_acc.capacity} live rows, "
                f"more than acc_capacity {acc_capacity}")
        if tuple(meta.get("mesh_shape", ())) != mesh_shape:
            raise ValueError(f"checkpoint mesh {meta.get('mesh_shape')} != "
                             f"current {mesh_shape}")
        if int(meta.get("process_count", 1)) != world:
            raise ValueError("checkpoint process count mismatch")
        check_resume_meta(meta, path, **settings)
        return local_acc, meta

    state = {"acc": None, "start": 0, "overflow": 0, "runs": []}

    def _adopt(local_acc, meta):
        state.update(acc=local_acc,
                     start=int(meta.get("batches_done", 0)),
                     overflow=int(meta.get("overflow", 0)),
                     runs=list(meta.get("spill_runs", [])))

    if rank_ckpt:
        for p in (rank_ckpt, rank_ckpt + ".prev"):
            if os.path.exists(p):
                _adopt(*_validated_load(p))
                log.info("resumed rank %d at batch %d from %s (%d spill "
                         "runs)", pid, state["start"], p, len(state["runs"]))
                break
    if world > 1:
        # Writes are per rank and asynchronous, so a kill inside the write
        # window can leave ranks at different batches: resuming so would
        # desynchronize the collectives.  Ranks ahead rewind to .prev;
        # otherwise the second exchange fails on every rank alike.
        def _gather_done():
            return all_gather_tiled(torch.tensor(
                [state["start"]], dtype=torch.int64, device=dev),
                mesh).cpu().numpy()

        all_done = _gather_done()
        if not (all_done == all_done[0]).all():
            m = int(all_done.min())
            log.warning("rank checkpoints disagree on batches_done %s; "
                        "rewinding to %d", all_done.tolist(), m)
            if state["start"] != m:
                prev = rank_ckpt + ".prev" if rank_ckpt else None
                if m == 0 and not state["runs"]:
                    state.update(acc=None, start=0, overflow=0)
                elif prev and os.path.exists(prev):
                    pl, pm = _validated_load(prev)
                    if int(pm.get("batches_done", 0)) == m:
                        _adopt(pl, pm)
            all_done = _gather_done()
            if not (all_done == all_done[0]).all():
                raise ValueError(
                    "rank checkpoints still disagree after rewind: "
                    f"{all_done.tolist()}; delete ALL rank checkpoints (and "
                    "spill runs) and re-run")
    start_batch = state["start"]
    spill_runs: list[str] = state["runs"]
    overflow = torch.zeros((), dtype=torch.int64, device=dev) + \
        state["overflow"]
    acc = empty_sharded_acc(mesh, acc_capacity)
    if state["acc"] is not None:  # its live rows, padded on the device
        acc = pad_wide(state["acc"].to(dev), acc_capacity)

    def _write_ckpt(snap, done_, ovf_, runs_, rotate=True):
        # the previous generation stays as .prev (a hard link: the save
        # writes a new file), so a kill at any moment leaves a whole
        # generation for the rewind above
        if rotate and os.path.exists(rank_ckpt):
            if os.path.exists(rank_ckpt + ".prev.tmp"):
                os.unlink(rank_ckpt + ".prev.tmp")
            os.link(rank_ckpt, rank_ckpt + ".prev.tmp")
            os.replace(rank_ckpt + ".prev.tmp", rank_ckpt + ".prev")
        save_wide(snap, rank_ckpt, compress=False, meta={
            "batches_done": done_, "overflow": int(ovf_),
            "mesh_shape": list(mesh_shape), "process_count": world,
            "spill_runs": runs_, **settings})

    writer = AsyncCheckpointer(_write_ckpt) if rank_ckpt else None
    done = start_batch
    t0 = time.perf_counter()
    feeder = _Feeder(feed, depth=3, skip=start_batch)
    feeder.start()
    try:
        while (item := feeder.q.get()) is not None:
            if isinstance(item, BaseException):
                raise item
            i, wire = item
            up = _upload(wire, dev)
            acc, overflow = step(acc, overflow, up[:, cols].contiguous(),
                                 up[:, nw])
            done = i + 1
            if stats is not None:
                ls = wire[:, nw].astype(np.int64)
                stats.record_batch(int((ls > 0).sum()), int(ls.sum()),
                                   int(np.maximum(ls - (k - 1), 0).sum()), 0)
            if writer is None or done % ckpt_every:
                continue
            # the accumulator functions return new tensors, so this
            # reference is a consistent snapshot for the writer thread
            writer.submit(acc, done, overflow, list(spill_runs))
            log.info("rank %d checkpoint %d submitted", pid, done)
            if spill_dir is None:
                continue
            # the spill is collective: every rank decides on the fullest
            # rank's live count, at the same batch
            fullest = int(all_gather_tiled(torch.tensor(
                [min(acc.n_unique, acc_capacity)], device=dev), mesh).max())
            if fullest <= spill_threshold * acc_capacity:
                continue
            writer.close()
            run_path = os.path.join(
                spill_dir, f"run_rank{pid}_{len(spill_runs):04d}.npz")
            save_wide(acc, run_path, {"mesh_shape": list(mesh_shape),
                                      "process_count": world},
                      compress=False)
            spill_runs.append(run_path)
            acc = empty_sharded_acc(mesh, acc_capacity)
            log.info("rank %d spilled run %d at batch %d", pid,
                     len(spill_runs) - 1, done)
            # persist the run list and the empty accumulator at once
            writer.submit(acc, done, overflow, list(spill_runs))
    finally:
        feeder.stop()
        if writer is not None:
            writer.close()
    if done == start_batch and start_batch == 0:
        raise ValueError("empty batch stream")
    ovf = int(overflow)
    log.info("rank %d counted batches %d-%d in %.3f s (checkpoint joins "
             "%.3f s)", pid, start_batch + 1, done, time.perf_counter() - t0,
             writer.wait_s if writer is not None else 0.0)
    t0 = time.perf_counter()
    if rank_ckpt:  # the final state; .prev keeps the last interval's
        _write_ckpt(acc, done, ovf, list(spill_runs), rotate=False)
    n_unique = int(all_reduce_sum(torch.tensor(acc.n_unique, device=dev),
                                  mesh))
    local = acc.trim()
    local = WideCounts(keys=local.keys, length=local.length,
                       counts=local.counts, n_unique=n_unique)
    out_meta = {"k": k, "canonical": canonical, "overflow": ovf,
                "mesh_shape": list(mesh_shape), "process_count": world}
    if spill_runs:
        # the exact K-way merge of this rank's runs and accumulator
        parts = [load_live(p)[0] for p in spill_runs]
        local = merge_runs(parts + [local], device=dev)
        log.info("rank %d merged %d spill runs -> %d groups", pid,
                 len(spill_runs), local.n_unique)
        out_meta["mesh_shape"] = [1, 1]  # a flat merged table
        out_meta["spilled"] = len(spill_runs)
    if out:
        save_wide(local, _rank_path(out, pid), out_meta, compress=False)
    log.info("rank %d wrote its final checkpoint and result in %.3f s",
             pid, time.perf_counter() - t0)
    if stats is not None and step.slots_sent:
        stats.merge_efficiency = int(step.live_sent) / step.slots_sent
    return local, ovf


def merge_rank_files(paths: list[str]) -> WideCounts:
    """Host-side union of per-rank result files (of either package).

    Rank shards own disjoint hash ranges, so this is normally a plain
    concatenation; the merge is the general K-way run merge all the same,
    so a wrong or repeated file set still gives exact per-key totals."""
    return merge_runs([load_live(p)[0] for p in paths], prefer_device=False,
                      device="cpu")
