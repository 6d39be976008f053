"""What the probe families share: the result records, timing, the least
time the card could take, comparison."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import subprocess
import tempfile
import time
from typing import Callable, Iterator

import numpy as np
import torch

from ..bench import hbm_bytes_per_s
from ..kernels.segment_copy import CopyPlan
from ..kernels.words import to_u32
from ..runs.common import card_line
from ..utils.profiling import synchronize

INT32_LANES_PER_SM = 64  # Hopper: 4 partitions x 16 INT32 lanes


@dataclasses.dataclass
class Record:
    """One probe's outcome.

    ``correct``: the wrapper's result equals the plain version's and, where
    the probe script had one, its numpy oracle.  ``device``: where it ran;
    on the CPU the wrapper is the plain version and no time is a device
    time.  ``max_abs_err``: the
    largest difference between wrapper and plain version, word for word,
    as unsigned 32-bit integers.  ``ms`` / ``plain_ms``: one call of the
    wrapper / of the plain version (on the CPU the wrapper is the plain
    version; None where the probe times a library call alone).  ``ops``
    is the script's operation count for a rate (stages times words),
    printed as G ``ops_label``/s, and ``copies`` / ``nbytes`` the copies
    and bytes moved (read + write) for a copy family.  ``detail``: what
    else the probe measured, printed after the times.

    On a card, ``graph_ms`` is one kernel call's own time, from many calls
    captured in one CUDA graph (no host launch cost; where bytes set the
    bound, each call with its inputs out of the L2, see ``graph_ms``);
    ``bound_ms`` the least time the card could take for the same function
    (``bound_by`` "bytes" or "operations", see ``bound_ms``); ``library``
    the one PyTorch call that computes the same function (``library_ms``,
    timed the same way), or "none: " and the reason.  Each is None on the
    CPU.
    """

    name: str
    family: str
    kernel: str
    site: str  # the script's pallas_call this probe stands for
    device: str
    correct: bool
    max_abs_err: int
    ms: float
    plain_ms: float | None
    ops: int | None = None
    ops_label: str = "ops"
    copies: int | None = None
    nbytes: int | None = None
    graph_ms: float | None = None
    bound_ms: float | None = None
    bound_by: str | None = None
    library: str | None = None
    library_ms: float | None = None
    detail: dict | None = None

    def line(self) -> str:
        """The human-readable line the probe prints."""
        who = ("library" if self.kernel == "library"
               else "kernel" if self.device.startswith("cuda") else "wrapper")
        if self.family == "capability":
            return "; ".join(
                [f"{self.name}: OK correct: {self.correct}  ({who} "
                 f"{self.ms:.4f} ms, plain {self.plain_ms:.4f} ms)"]
                + self._own())
        parts = [f"{self.name}: correct: {self.correct}"]
        for who, ms in ((who, self.ms), ("plain", self.plain_ms)):
            if ms is None:
                continue
            s = f"{who} {ms:.4f} ms"
            if self.ops:
                s += f" -> {self.ops / ms / 1e6:.3f} G {self.ops_label}/s"
            if self.copies:
                s += (f" -> {self.copies / ms * 1e3:.1f} copies/s, "
                      f"{self.nbytes / ms / 1e6:.3f} GB/s")
            parts.append(s)
        if self.detail:
            parts.append(", ".join(f"{k} {v}" for k, v in
                                   self.detail.items()))
        return "; ".join(parts + self._own())

    def _own(self) -> list[str]:
        if self.graph_ms is None:
            return []
        lib = (self.library if self.library_ms is None
               else f"{self.library} {self.library_ms:.4f} ms")
        return [f"graph {self.graph_ms:.4f} ms, bound {self.bound_ms:.6f} ms "
                f"({self.bound_by}, {100 * self.bound_ms / self.graph_ms:.2f}%)"
                f", library {lib}"]

    def own_times(self, run: Callable[[], object], device: torch.device,
                  nbytes: int, ops: int, library: str,
                  library_fn: Callable[[], object] | None = None) -> "Record":
        """Fills the card-only fields: the bound of ``nbytes`` moved and
        ``ops`` int32 operations, and ``run``'s and ``library_fn``'s graph
        times, cold where bytes set the bound.  On the CPU it leaves them
        None."""
        if device.type == "cuda":
            self.bound_ms, self.bound_by = bound_ms(nbytes, ops, device)
            cold = self.bound_by == "bytes"
            self.graph_ms = graph_ms(run, device, cold=cold)
            self.library = library
            if library_fn is not None:
                self.library_ms = graph_ms(library_fn, device, cold=cold)
        return self


def time_ms(fn: Callable[[], object], device: torch.device,
            iters: int) -> float:
    """Mean ms of one ``fn()`` call, warm: CUDA events around ``iters``
    calls on a card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def graph_ms(fn: Callable[[], object], device: torch.device,
             budget_ms: float = 2.0, cold: bool = False) -> float:
    """Mean ms of one ``fn()`` call with no host launch cost: enough calls
    to fill about ``budget_ms`` (1 to 200) captured in one CUDA graph,
    replayed three times between CUDA events.

    Replayed calls on the same inputs find them in the L2 when they fit
    there.  With ``cold``, each call follows a read of twice the L2, so it
    takes its inputs from device memory, as a call on inputs larger than
    the L2 does; the time of those reads alone, from a graph of their
    own, is taken off.  Needs a card."""
    once = time_ms(fn, device, 1)
    calls = max(1, min(200, int(budget_ms / max(once, 1e-3))))
    if not cold:
        return _replay_ms([fn], calls, device)
    evict = _l2_eviction(device)
    return (_replay_ms([evict, fn], calls, device)
            - _replay_ms([evict], calls, device))


def _replay_ms(fns: list[Callable[[], object]], calls: int,
               device: torch.device) -> float:
    """ms of one round of ``fns`` in a CUDA graph of ``calls`` rounds."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for fn in fns:  # capture wants its first calls off the default stream
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / (3 * calls)


@functools.lru_cache(maxsize=None)
def _l2_eviction(device: torch.device) -> Callable[[], object]:
    """A call that reads twice the card's L2 (a sum of float32 words): the
    lines it leaves there are clean, so evicting them later costs
    nothing."""
    words = torch.cuda.get_device_properties(device).L2_cache_size // 2
    buf = torch.ones(words, dtype=torch.float32, device=device)
    sink = torch.empty((), dtype=torch.float32, device=device)
    return lambda: torch.sum(buf, 0, out=sink)


def copy_library(src: torch.Tensor, plan: CopyPlan
                 ) -> tuple[str, Callable[[], torch.Tensor] | None]:
    """The one PyTorch call that computes ``plan``'s destination, where
    there is one, or ("none: " and the reason, None).  When the copies'
    destinations lie one after another in copy order and fill the
    destination, it is the source's windows of ``seg`` words gathered at
    the source offsets: ``index_select`` of ``src.unfold``, with the
    offsets on the device."""
    if plan.overlap:
        return "none: overlapping destinations, the last writer wins", None
    out_off = plan.out_off.cpu().numpy()
    if not (plan.n_out == plan.copies * plan.seg
            and np.array_equal(out_off, np.arange(plan.copies) * plan.seg)):
        return "none: the destinations do not fill it in copy order", None
    windows = src.reshape(-1).unfold(0, plan.seg, 1)
    return ("src.unfold(0, seg, 1).index_select(0, in_off)",
            lambda: windows.index_select(0, plan.in_off).reshape(-1))


@functools.lru_cache(maxsize=None)
def int32_ops_per_s(device: torch.device) -> float:
    """The card's int32 issue rate: SMs x INT32 lanes x the highest SM
    clock that nvidia-smi reports."""
    index = device.index if device.index is not None else 0
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * INT32_LANES_PER_SM * float(out.stdout.split()[0]) * 1e6


def bound_ms(nbytes: int, ops: int, device: torch.device
             ) -> tuple[float, str]:
    """The least ms the card could take to move ``nbytes`` (each input
    read once, each output written once) at its published HBM rate and
    to issue ``ops`` int32 operations, the larger of the two, and which
    one it is ("bytes" or "operations")."""
    by_bytes = 1e3 * nbytes / hbm_bytes_per_s(device)
    by_ops = 1e3 * ops / int32_ops_per_s(device)
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def sort_ops(n: int, width: int) -> int:
    """Comparisons that sorting ``n`` keys in rows of ``width`` needs,
    about n log2(width), counted as one int32 operation each (a floor: a
    64-bit compare takes more)."""
    return n * max(1, width.bit_length() - 1)


def words(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array of 32-bit words on ``device``; uint32 travels as
    int32 bits (torch's uint32 has few operators)."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def host(t: torch.Tensor, dtype=np.uint32) -> np.ndarray:
    """A tensor of 32-bit words as a numpy array of ``dtype``."""
    return t.contiguous().cpu().numpy().view(dtype)


def max_abs_err(a, b) -> int:
    """Largest word-for-word difference of two word arrays (tensors, or
    tuples of tensors) as unsigned 32-bit integers, computed on their
    device."""
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} "
                         "differ")
    if a.numel() == 0:
        return 0
    return int((to_u32(a) - to_u32(b)).abs().max())


# --- the phase probes -------------------------------------------------------


@dataclasses.dataclass
class PhaseRecord:
    """One phase probe's outcome: a part of the engine's path that a
    script of ``scripts/`` timed on the TPU, timed here.

    ``seconds``: each phase's wall on the host clock, with the device
    synchronized inside the window (a list where the script repeated the
    phase); ``correct``: every check of the probe held; ``detail``: what
    else it measured (sizes, rates, the route taken, a finding);
    ``tables``: each result table's ``table_digest``, for comparing with
    another route or package; ``card``: ``nvidia-smi``'s name and power
    limit of the card, None on the CPU, where no time is a device time.
    """

    name: str
    family: str
    site: str  # the script this probe ports
    device: str
    correct: bool
    seconds: dict
    detail: dict | None = None
    tables: dict | None = None
    card: str | None = None

    def line(self) -> str:
        """The human-readable line the probe prints."""
        def fmt(v):
            if isinstance(v, (list, tuple)):
                return "[" + ", ".join(fmt(x) for x in v) + "]"
            return f"{v:.4f} s" if isinstance(v, float) else str(v)

        parts = [f"{self.name}: correct: {self.correct}"]
        if self.seconds:
            parts.append(", ".join(f"{k} {fmt(v)}"
                                   for k, v in self.seconds.items()))
        if self.detail:
            parts.append(", ".join(f"{k} {v}" for k, v in
                                   self.detail.items()))
        if self.tables:
            parts.append(", ".join(
                f"{k}: {t['groups']} groups, total {t['total']}"
                for k, t in self.tables.items()))
        parts.append(f"[{self.card or self.device}]")
        return "; ".join(parts)


def card_of(device: torch.device) -> str | None:
    """The card's name and power limit for a CUDA device, else None."""
    return card_line() if device.type == "cuda" else None


def wall(fn: Callable[[], object], device: torch.device
         ) -> tuple[object, float]:
    """(fn(), seconds of the call): the host clock, with the device's
    queued work finished before the window opens and inside it."""
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def best_wall(fn: Callable[[], object], device: torch.device,
              repeats: int = 3) -> tuple[object, float]:
    """(the last result, the least ``wall`` of ``repeats`` calls after a
    warm one), as the scripts' ``bench`` took it."""
    out, best = fn(), float("inf")
    for _ in range(repeats):
        out, s = wall(fn, device)
        best = min(best, s)
    return out, best


def twice(fn: Callable[[], object], device: torch.device
          ) -> tuple[object, list[float]]:
    """(the last result, the ``wall`` of each of two calls), as the phase
    scripts timed each part twice."""
    out, times = None, []
    for _ in range(2):
        out, s = wall(fn, device)
        times.append(s)
    return out, times


@contextlib.contextmanager
def workspace(workdir: str | None) -> Iterator[str]:
    """``workdir``, or a temporary directory removed afterwards."""
    if workdir is not None:
        yield workdir
        return
    with tempfile.TemporaryDirectory(prefix="kmer_probes_") as d:
        yield d


def rows_digest(hi, lo, length, counts) -> dict:
    """A result table's live rows in key order, as (hi uint32, lo uint32,
    length int32, int64 counts) arrays: their number, their counts' total
    and the SHA-256 of their bytes, so two tables of either package
    compare exactly without keeping both."""
    h = hashlib.sha256()
    for a, dt in ((hi, np.uint32), (lo, np.uint32), (length, np.int32),
                  (counts, np.int64)):
        h.update(np.ascontiguousarray(np.asarray(a).astype(dt)).tobytes())
    counts = np.asarray(counts, np.int64)
    return {"groups": int(counts.size), "total": int(counts.sum()),
            "sha256": h.hexdigest()}


def table_digest(table) -> dict:
    """``rows_digest`` of a port WideCounts' live rows."""
    t = table.trim()
    hi, lo, length, _, _ = t.to_numpy()
    return rows_digest(hi, lo, length, t.counts64())
