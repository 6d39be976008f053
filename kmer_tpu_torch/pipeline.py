"""Disk-to-table counting: ``count_file`` and the streaming fold.

The counterpart of ``kmer_tpu/pipeline.py``.  A producer thread parses
the file (native C) and packs fixed-width 2-bit rows, one ``[B, W/16 + 1]``
uint32 wire array per batch with the row lengths in the last column,
while the device works on the batch before.  On the device each batch is
turned into its k-window keys (canonicalized when asked) and valid mask by
one kernel, ``kernels/wire_keys``, counted, its live groups compacted,
and merged into a 64-bit ``WideCounts`` accumulator that grows in powers
of two and, at a device slot budget, spills sorted runs that finish with
an exact K-way merge.  Confirmed points are checkpointed so a killed run
resumes where it stopped.  A small file is one auto-sized batch.

``kmer_tpu``'s fold reverts a batch on the device when the merge
overflows and replays it later, because reading a device value stalls
the TPU's asynchronous dispatch.  Here the fold's boolean-mask selects
synchronize anyway, so the merged distinct count is read after each
batch and acted on before the next: every batch is folded exactly once
into the table that survives, and nothing is replayed.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from .codec import MAX_K
from .device import resolve_device
from .errors import InvalidKmerLengthError
from .kernels.wire_keys import wire_keys
from .native import rows_packed
from .ops.count import count_windows
from .ops.wide import (
    SpillRuns, WideCounts, fit_groups, live_rows, merge_groups, merge_runs,
    pad_wide, table_groups)
from .utils.logging import StatsCounters, get_logger
from .utils import profiling
from .utils.profiling import Profile, phase_timer, span, synchronize


def auto_width(lengths: np.ndarray, cap: int = 1024) -> int:
    """Row width for a read-length sample: the max length rounded up to a
    16-base word, capped (longer reads split exactly)."""
    mx = int(lengths.max()) if lengths.size else 16
    return max(32, min(cap, -(-mx // 16) * 16))


def auto_batch(width: int, k: int, target_windows: int = 1 << 26) -> int:
    """Reads per batch, sized so a batch carries ~64M window slots."""
    per = max(width - k + 1, 1)
    b = max(1, target_windows // per)
    return max(4096, min(1 << 20, 1 << int(b - 1).bit_length()))


def file_batch_feed(path: str, fmt: str, k: int, batch: int | None,
                    width: int | None, chunk_bytes: int | None = None,
                    width_multiple: int = 16,
                    target_windows: int = 1 << 26,
                    n_policy: str = "skip",
                    stats: StatsCounters | None = None,
                    ) -> tuple[Iterator, int, int, int | None]:
    """Fixed-shape feed for a FASTA/FASTQ file with auto batch/width.

    Returns (iterator of (words [B, W/16] uint32, lengths [B] uint16),
    batch, width, est_windows).  Width is sampled from the probe's window
    (``io.ingest.probe_sample``: at most the file's first
    ``min(chunk_bytes, 16 MiB)``, cut at a record boundary where it holds
    one) when not given; longer reads split exactly, shorter ones pad.
    The width rounds up to ``width_multiple`` (16 * seq for a sharded
    consumer, whose word axis must split evenly).  ``est_windows``
    scales the k-mer windows of the probe's window to the whole file by
    the bytes on disk that window stands for (None when no record was
    probed or the file's size cannot be read), which clamps an auto-sized
    batch to a small file.
    ``n_policy`` "break" makes every contig (maximal ACGT run) a read of
    its own (``io.ingest.iter_encoded_chunks``), so the rows, the width
    sample and the estimate go contig by contig; the iterator adds the
    parse's break counters into ``stats``, and a probe whose sample ended
    inside a record counts one ``stats.probe_cuts``.
    """
    from .io.ingest import (DEFAULT_CHUNK_BYTES, encode_window,
                            iter_encoded_chunks, probe_sample)

    cb = chunk_bytes or DEFAULT_CHUNK_BYTES
    est_windows = None
    probe_bytes = min(cb, 16 << 20)
    try:
        fsize = os.path.getsize(path)
    except OSError:
        fsize = None
    with span("feed.probe"):
        window, disk_bytes, cut = probe_sample(path, fmt, probe_bytes)
        codes, offs = encode_window(window, fmt, n_policy)
        if offs.size > 1:
            lens = np.diff(offs)
            if not width:
                width = auto_width(lens)
            if fsize is not None:
                wins = int(np.maximum(lens - (k - 1), 0).sum())
                est_windows = int(
                    wins * max(fsize / max(disk_bytes, 1), 1.0))
        if cut and stats is not None:
            stats.probe_cuts += 1
    width_multiple = max(16, width_multiple)
    width = -(-(width or 256) // width_multiple) * width_multiple
    while width <= k - 1:
        width += width_multiple
    if width > 0xFFFF:
        raise ValueError(
            f"width {width} exceeds the uint16 row-length bound (65535); "
            "long reads split exactly, so smaller widths lose nothing")
    if not batch:
        batch = auto_batch(width, k, target_windows)
        if est_windows is not None:
            # small files must not pay a full-size batch of padding
            need_rows = est_windows // max(width - k + 1, 1) + 1
            batch = min(batch, max(4096, 1 << int(need_rows).bit_length()))

    def gen():
        # each chunk's packing is a feed.pack span (with the packed rows'
        # bytes); it closes before the batches it made are yielded
        buf_w: list[np.ndarray] = []
        buf_l: list[np.ndarray] = []
        pending = 0
        for codes, offs in iter_encoded_chunks(path, fmt, cb, n_policy,
                                               stats):
            with span("feed.pack") as pack:
                words, lens = rows_packed(codes, offs, width, k)
                pack.nbytes = words.nbytes + lens.nbytes
                buf_w.append(words)
                buf_l.append(lens)
                pending += words.shape[0]
                ready = []
                if pending >= batch:
                    allw = np.concatenate(buf_w)
                    alll = np.concatenate(buf_l)
                    n_full = (pending // batch) * batch
                    ready = [(allw[s: s + batch], alll[s: s + batch])
                             for s in range(0, n_full, batch)]
                    buf_w = [allw[n_full:]]
                    buf_l = [alll[n_full:]]
                    pending -= n_full
            yield from ready
        if pending:  # zero-length-padded fixed-shape tail
            with span("feed.pack"):
                tail = list(_padded_batches(np.concatenate(buf_w),
                                            np.concatenate(buf_l), batch))
            yield from tail

    return gen(), batch, width, est_windows


def _padded_batches(words: np.ndarray, lengths: np.ndarray, batch: int):
    """Fixed-shape batches of packed rows; the last one zero-padded."""
    for s in range(0, words.shape[0], batch):
        w = words[s: s + batch]
        ln = lengths[s: s + batch]
        if w.shape[0] < batch:
            pad = batch - w.shape[0]
            w = np.concatenate([w, np.zeros((pad, w.shape[1]), np.uint32)])
            ln = np.concatenate([ln, np.zeros(pad, ln.dtype)])
        yield w, ln


def initial_capacity(capacity: int, k: int, est_windows: int) -> int:
    """Clamp the starting accumulator capacity by what the workload can
    possibly need: distinct keys <= total windows and <= 4^k.  Growth
    covers an underestimate."""
    upper = max(int(est_windows), 1)
    if k <= 26:
        upper = min(upper, 4 ** k)
    upper = max(1 << 12, 1 << int(upper - 1).bit_length())
    return min(1 << max(3, int(capacity - 1).bit_length()), upper)


def column_batch_feed(seqs, k: int, batch: int | None = None,
                      width: int | None = None,
                      width_cap: int = 1 << 14) -> tuple[Iterator, int, int]:
    """Fixed-shape packed feed over in-memory dna strings (the CSV
    dna-column path).  Long rows split exactly; short ones pad."""
    from .native import encode_dna_fast

    enc = [encode_dna_fast(s) for s in seqs]
    lens = np.asarray([e.size for e in enc], np.int64)
    if not width:
        width = auto_width(lens, cap=width_cap)
    width = -(-width // 16) * 16
    while width <= k - 1:
        width += 16
    if not batch:
        batch = auto_batch(width, k)
    stream = np.concatenate(enc) if enc else np.zeros(0, np.uint8)
    words, plens = split_rows(stream, lens, width, k)
    return _padded_batches(words, plens, batch), batch, width


def split_rows(stream: np.ndarray, lens, width: int, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Sequences laid end to end in ``stream``, ``lens`` bases each ->
    ``rows_packed``'s (words, row lengths): rows of at most ``width``
    bases that overlap by k-1, so every window is valid in exactly one
    row."""
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return rows_packed(stream, offs, width, k)


def _combine(words: np.ndarray, lengths) -> np.ndarray:
    """One wire array per batch: [B, W/16 + 1] uint32, the row lengths in
    the last column, so each batch is one upload."""
    b, nw = words.shape
    combo = np.empty((b, nw + 1), np.uint32)
    combo[:, :nw] = words
    combo[:, nw] = np.asarray(lengths).astype(np.uint32)
    return combo


class _Feeder(threading.Thread):
    """Producer: pulls (rows, lengths) batches from the feed, packs raw
    2-bit codes to words, and queues (index, wire array), then None; an
    exception in the feed is queued for the consumer to raise.  The first
    ``skip`` batches (done before a resume) are read and dropped.  The
    consumer calls ``stop`` when it is done, on every path, so the thread
    never stays blocked on a full queue.  The thread's spans (the feed's,
    ``feed.pack``, ``feed.put``) belong to the job and span open where it
    was built."""

    def __init__(self, batches: Iterable, depth: int, skip: int = 0):
        super().__init__(daemon=True)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._batches = batches
        self._skip = skip
        self._halt = threading.Event()
        self._ctx = profiling.context()

    def stop(self) -> None:
        self._halt.set()
        try:  # unblock a producer stuck on a full queue
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass

    def _put(self, item) -> bool:
        with span("feed.put"):
            while not self._halt.is_set():
                try:
                    self.q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

    def run(self):
        with profiling.adopt(self._ctx):
            self._run()

    def _run(self):
        from .native import pack2bit_rows

        try:
            for i, (rows, lengths) in enumerate(self._batches):
                if self._halt.is_set():
                    return
                if i < self._skip:
                    continue
                with span("feed.pack") as pack:
                    rows = np.asarray(rows)
                    if rows.dtype != np.uint32:  # raw codes: pack here
                        rows = pack2bit_rows(rows)
                    wire = _combine(rows, lengths)
                    pack.nbytes = wire.nbytes
                if not self._put((i, wire)):
                    return
            self._put(None)
        except BaseException as e:  # raised again in the consumer
            self._put(e)


def _next(feeder: _Feeder):
    """The consumer's next item, its wait a ``queue.wait`` span."""
    with span("queue.wait"):
        return feeder.q.get()


def _upload(wire: np.ndarray, device: torch.device) -> torch.Tensor:
    """A wire array to the device (uint32 travels as int32 bits)."""
    with span("upload", wire.nbytes):
        return torch.from_numpy(wire.view(np.int32)).to(device)


def _record(stats: StatsCounters | None, wire: np.ndarray, k: int) -> None:
    if stats is not None:
        ls = wire[:, -1].astype(np.int64)
        stats.record_batch(int((ls > 0).sum()), int(ls.sum()),
                           int(np.maximum(ls - (k - 1), 0).sum()), 0)


# --- the streaming fold ---------------------------------------------------


class PipelineCheckpoint:
    """Checkpoint/resume state for count_batches_pipelined.  Snapshots are
    written only at confirmed points, so a resumed accumulator holds every
    batch below ``batches_done`` exactly once."""

    def __init__(self, path: str):
        self.path = path
        self.acc: WideCounts | None = None
        self.batches_done = 0
        self.capacity = 0
        self.spill_runs: list[str] = []
        self.meta: dict = {}
        if os.path.exists(path):
            from .parallel.streaming import load_wide

            self.acc, meta = load_wide(path)
            self.meta = meta
            self.batches_done = int(meta.get("batches_done", 0))
            self.capacity = int(meta.get("capacity", self.acc.capacity))
            self.spill_runs = list(meta.get("spill_runs", []))


def save_pipeline_ckpt(acc: WideCounts, path: str, batches_done: int,
                       capacity: int, spill_runs: list[str],
                       k: int, canonical: bool,
                       batch: int | None = None,
                       width: int | None = None,
                       n_policy: str = "skip") -> None:
    """Confirmed-point checkpoint in ``save_wide``'s layout, uncompressed
    (zlib takes seconds for every 10M rows, and a checkpoint is written
    while the count waits or runs beside it; either package loads it).
    k, canonical, batch, width and the feed's ``n_policy`` are recorded
    so that a resume with other flags fails instead of folding mismatched
    windows or skipping the wrong reads.  Logs one line a checkpoint
    written."""
    from .parallel.streaming import save_wide

    save_wide(acc, path, {
        "batches_done": batches_done,
        "capacity": capacity,
        "spill_runs": spill_runs,
        "k": k,
        "canonical": canonical,
        "batch": batch,
        "width": width,
        "n_policy": n_policy,
    }, compress=False)
    get_logger().info("pipeline: checkpoint at batch %d written to %s",
                      batches_done, path)


class _PipelineRun:
    """One streaming count: the accumulator, its capacity and the spills.

    ``fold`` reads the merged distinct count before it commits a batch:
    the merge fits the capacity (kept), fits the budget (the capacity
    grows to fit), or does not fit the budget (the accumulator spills and
    the batch is kept alone; a batch that alone exceeds the budget is an
    error).  Then, like ``kmer_tpu``'s sampled policy, the capacity grows
    ahead of need past ``grow_threshold``, and at the budget the
    accumulator spills past ``spill_threshold``.
    """

    def __init__(self, k, canonical, width, cap, max_cap, spills,
                 spill_threshold, grow_threshold, stats, profile, device):
        self.k = k
        self.canonical = canonical
        self.width = width
        self.cap = cap
        self.max_cap = max_cap
        self.spills: SpillRuns = spills
        self.spill_threshold = spill_threshold
        self.grow_threshold = grow_threshold
        self.stats = stats
        self.profile = profile
        self.device = device
        self.log = get_logger()
        self.acc = WideCounts.empty(cap, device)

    def phase(self, name: str):
        """Times a phase into the run's profile (with a synchronize)."""
        sync = self.device if self.profile is not None else None
        return phase_timer(self.profile, name, sync=sync)

    def _at_max(self) -> bool:
        return self.max_cap is not None and self.cap >= self.max_cap

    def _grow(self, need: int) -> None:
        new_cap = self.cap
        target = max(2 * self.cap, need + (need >> 2) + 1)
        while new_cap < target:
            new_cap *= 2
        if self.max_cap is not None:
            new_cap = min(new_cap, self.max_cap)
        if new_cap > self.cap:
            self.log.info("pipeline: growing %d -> %d slots", self.cap,
                          new_cap)
            self.cap = new_cap
            if self.stats is not None:
                self.stats.grows += 1

    def _spill(self) -> None:
        with self.phase("spill"):
            if self.spills.spill(self.acc) and self.stats is not None:
                self.stats.spills += 1
            self.acc = WideCounts.empty(self.cap, self.device)

    def fold(self, idx: int, wire: np.ndarray) -> None:
        """Folds batch ``idx`` into the accumulator, exactly once."""
        k = self.k
        with self.phase("extract"):
            keys, valid = wire_keys(_upload(wire, self.device), self.width,
                                    k, self.canonical)
        with self.phase("count"):
            table = count_windows(keys, valid, k)
        del keys, valid
        with self.phase("compact"):
            b_keys, b_counts = table_groups(table)
            a_keys, a_counts = live_rows(self.acc)
        del table
        with self.phase("merge"):
            keys, counts = merge_groups(a_keys, a_counts, b_keys, b_counts)
        del a_keys, a_counts
        n = keys.numel()
        if n > self.cap and self.max_cap is not None and n > self.max_cap:
            self._spill()
            keys, counts, n = b_keys, b_counts, b_keys.numel()
            if n > self.max_cap:
                raise ValueError(
                    f"batch {idx} needs {n} distinct slots "
                    f"but max_capacity is {self.max_cap}; shrink the batch "
                    "or raise --max-slots")
        del b_keys, b_counts
        if n > self.cap:
            self._grow(n)
        if not self._at_max() and n > self.grow_threshold * self.cap:
            self._grow(max(n + 1, int(self.cap / max(
                self.grow_threshold, 0.1)) + 1))
        with self.phase("merge"):
            self.acc = fit_groups(keys, counts, k, self.cap)
        if self._at_max() and n > self.spill_threshold * self.cap:
            self._spill()


@profiling.job_entry
def count_batches_pipelined(
    batches: Iterable[tuple[np.ndarray, np.ndarray]],
    k: int,
    canonical: bool = False,
    capacity: int = 1 << 24,
    max_capacity: int | None = None,
    spill_dir: str | None = None,
    spill_threshold: float = 0.85,
    stats: StatsCounters | None = None,
    ckpt: PipelineCheckpoint | None = None,
    ckpt_every_s: float = 60.0,
    queue_depth: int = 3,
    grow_threshold: float = 0.7,
    *,
    device: str | torch.device,
    profile: Profile | None = None,
    n_policy: str = "skip",
) -> WideCounts:
    """Exact 64-bit GROUP BY over fixed-shape batches on ``device``.

    Batches are (codes [B, W] uint8, lengths [B]) or already packed
    (words [B, W/16] uint32, lengths [B]), all of one shape (pad the
    tail; zero-length rows contribute nothing).  Returns a WideCounts on
    the device when nothing spilled, a host one otherwise.  The capacity
    starts at a power of two and only grows, up to ``max_capacity``
    rounded down to a power of two (None: unbounded); past it, live slots
    spill to host or ``spill_dir`` sorted runs, and the result is their
    exact K-way merge.  With ``profile``, the device phases of every
    batch are timed (with a synchronize around each).  ``n_policy`` is
    the one the batches were parsed under: a checkpoint records it, and
    a resume under another raises (a checkpoint without it was written
    under "skip", the only policy ``kmer_tpu`` has).
    """
    device = resolve_device(device)
    cap = 1 << max(3, int(capacity - 1).bit_length())
    max_cap = None
    if max_capacity is not None and max_capacity:
        # the budget rounds DOWN to a power of two (growth doubles from
        # one); the starting capacity, which rounds up, clamps to it
        max_cap = max(8, 1 << (int(max_capacity).bit_length() - 1))
        cap = min(cap, max_cap)
        if ckpt is not None and spill_dir is None:
            raise ValueError(
                "a checkpointed count with a device budget needs "
                "spill_dir: in-RAM spill runs do not survive a restart")
    spills = SpillRuns(spill_dir)
    resumed = ckpt is not None and ckpt.acc is not None
    start = 0
    if resumed:
        start = ckpt.batches_done
        spills.runs = list(ckpt.spill_runs)
        cap = max(cap, 1 << max(3, int(ckpt.capacity - 1).bit_length()))
        # a resume with other flags would fold mismatched windows (or
        # skip the wrong number of reads) on top of the accumulator; the
        # batch shape is checked at the first batch
        _check_resume(ckpt, k=k, canonical=bool(canonical),
                      n_policy=n_policy)

    feeder = _Feeder(batches, queue_depth, skip=start)
    feeder.start()
    try:
        item = _next(feeder)
        if isinstance(item, BaseException):
            raise item
        if item is None:
            if resumed:
                return _finish(ckpt.acc.to(device), spills, device)
            raise ValueError("empty batch stream")
        B, nwp1 = item[1].shape
        width = (nwp1 - 1) * 16
        if resumed:
            _check_resume(ckpt, batch=B, width=width)
        run = _PipelineRun(k, canonical, width, cap, max_cap, spills,
                           spill_threshold, grow_threshold, stats, profile,
                           device)
        if resumed:
            run.acc = pad_wide(ckpt.acc.to(device), run.cap)
        writer = None
        if ckpt is not None:
            from .parallel.streaming import AsyncCheckpointer

            def _write(acc, done, cap_now, runs_now):
                save_pipeline_ckpt(acc, ckpt.path, done, cap_now, runs_now,
                                   k, canonical, batch=B, width=width,
                                   n_policy=n_policy)
                ckpt.batches_done = done

            writer = AsyncCheckpointer(_write)
        last_ckpt_t = time.perf_counter()
        done = start
        while item is not None:
            if isinstance(item, BaseException):
                raise item
            idx, wire = item
            if wire.shape != (B, nwp1):
                raise ValueError(
                    f"batch {idx} shape {wire.shape} != first batch "
                    f"{(B, nwp1)}; the pipelined path requires one fixed "
                    "batch shape")
            run.fold(idx, wire)
            _record(stats, wire, k)
            done = idx + 1
            now = time.perf_counter()
            if (writer is not None and now - last_ckpt_t >= ckpt_every_s
                    and done > ckpt.batches_done):
                with run.phase("ckpt"):  # waits for the previous write
                    synchronize(device)  # the snapshot's work is done
                    writer.submit(run.acc, done, run.cap, list(spills.runs))
                last_ckpt_t = now
            item = _next(feeder)
        if writer is not None:
            with run.phase("ckpt"):
                writer.close()
                if done > ckpt.batches_done or ckpt.acc is None:
                    save_pipeline_ckpt(run.acc, ckpt.path, done, run.cap,
                                       list(spills.runs), k, canonical,
                                       batch=B, width=width,
                                       n_policy=n_policy)
                    ckpt.batches_done = done
    finally:
        feeder.stop()
    with run.phase("merge_runs"):
        return _finish(run.acc, spills, device)


def _check_resume(ckpt: PipelineCheckpoint, **want) -> None:
    """Raises where the checkpoint records another value of a flag than
    ``want`` gives; a checkpoint without ``n_policy`` was written under
    "skip", the only policy ``kmer_tpu`` has."""
    meta = {"n_policy": "skip", **ckpt.meta}
    for name, value in want.items():
        have = meta.get(name)
        if have is not None and have != value:
            raise ValueError(
                f"checkpoint {ckpt.path} was written with {name}={have}; "
                f"this resume uses {name}={value}")


def _finish(acc: WideCounts, spills: SpillRuns,
            device: torch.device) -> WideCounts:
    if not spills.runs:
        return acc
    runs = spills.load()
    runs.append(acc.trim())
    get_logger().info("pipeline: merging %d spill runs (%d rows)",
                      len(runs), sum(r.n_unique for r in runs))
    return merge_runs(runs, device=device)


@profiling.job_entry
def count_file(
    path: str,
    fmt: str,
    k: int,
    canonical: bool = False,
    batch: int | None = None,
    width: int | None = None,
    chunk_bytes: int | None = None,
    capacity: int = 1 << 24,
    max_capacity: int | None = None,
    spill_dir: str | None = None,
    stats: StatsCounters | None = None,
    ckpt_path: str | None = None,
    ckpt_every_s: float = 60.0,
    single_shot: bool | None = None,
    *,
    device: str | torch.device,
    profile: Profile | None = None,
    n_policy: str = "skip",
) -> WideCounts:
    """Count a FASTA/FASTQ file end to end on ``device`` through the
    streaming fold (``count_batches_pipelined``); a small file is one
    auto-sized batch.  ``single_shot`` must be None or False (one route).
    ``profile`` times the fold's device phases.

    ``n_policy`` says what a non-ACGT sequence byte (N, n, an IUPAC
    letter, anything the parser does not encode) does: "skip" (the
    default, ``kmer_tpu``'s) drops it and joins its flanks; "break" ends
    the contig at each maximal run of them, so no window contains or
    spans one and each contig's windows are counted as they would be
    alone, as jellyfish, meryl and KMC count.  ``stats.breaks`` and
    ``stats.break_bases`` count the contigs begun at a run and the bytes
    broken at.
    """
    device = resolve_device(device)
    if single_shot:
        raise ValueError("single_shot=True: count_file has one route, the "
                         "streaming fold")
    if not 1 <= k <= MAX_K:
        raise InvalidKmerLengthError()
    feed, _, _, _ = file_batch_feed(
        path, fmt, k, batch, width, chunk_bytes, n_policy=n_policy,
        stats=stats)
    try:
        # bases <= file bytes (FASTA ~1x, FASTQ ~0.45x); windows <= bases
        est = os.path.getsize(path) // (2 if fmt == "fastq" else 1)
        capacity = initial_capacity(capacity, k, est)
    except OSError:
        pass
    if max_capacity:
        capacity = min(capacity, max_capacity)
    ckpt = PipelineCheckpoint(ckpt_path) if ckpt_path else None
    return count_batches_pipelined(
        feed, k, canonical=canonical, capacity=capacity,
        max_capacity=max_capacity, spill_dir=spill_dir, stats=stats,
        ckpt=ckpt, ckpt_every_s=ckpt_every_s, device=device, profile=profile,
        n_policy=n_policy,
    )
