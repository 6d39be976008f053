"""The program's span records in a traced window, placed on the trace's
clock, and the copies' rates read from the trace alone.

While a ``torch.profiler`` records the thread that calls the entry,
``kmer_tpu_torch`` keeps a record of each of its spans in
``utils.profiling.TRACED.spans``, the feeder thread's too, whose
``record_function`` ranges the trace does not hold.  Of a record this
module reads only its name, OS thread, ``perf_counter_ns`` start and end
and bytes.  Where the records lie on the trace's clock, and which thread
is the feeder, it decides itself, from the trace: the main thread's
records pair with the trace's ranges of the same names.  A program that
keeps no records gives None, and so do the metrics that read them.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import statistics

from benchmark.trace import _merge

# bytes an element of each copy's tensor: the wire is int32 words (as
# ``Run.batch_shapes`` reads it)
COPY_ITEMSIZE = {"upload": 4}


@dataclasses.dataclass(frozen=True)
class Placed:
    """A span record at its place on the trace's clock (us)."""

    ts: float
    end: float
    name: str
    nbytes: int
    feeder: bool  # on another thread than the trace's


def records() -> list | None:
    """The program's span records, or None where it keeps none."""
    try:
        from kmer_tpu_torch.utils import profiling
    except ImportError:
        return None
    traced = getattr(profiling, "TRACED", None)  # a program without spans
    return list(traced.spans) if traced is not None else None


def offset_us(spans, ranges) -> tuple[float, int] | None:
    """(us to add to a record's ``start_ns / 1e3`` to put it on the trace's
    clock, the OS thread the trace holds), or None where no record pairs
    with a range.

    ``ranges`` are (name, start in us) of the trace's ranges on its main
    thread.  On each thread of ``spans``, the records of each name the
    trace holds, as many as the trace has and the newest (the trace ends
    the record), pair with those ranges in order; the thread with the most
    pairs is the trace's, and the median of its pairs' (range start -
    record start) is the offset.
    """
    by_name: dict[str, list[float]] = collections.defaultdict(list)
    for name, ts in ranges:
        by_name[name].append(float(ts))
    per_thread = collections.defaultdict(list)
    for s in spans:
        if s.name in by_name:
            per_thread[(s.thread, s.name)].append(s)
    diffs: dict[int, list[float]] = collections.defaultdict(list)
    for (thread, name), ss in per_thread.items():
        want = sorted(by_name[name])
        if len(ss) < len(want):
            continue
        ss = sorted(ss, key=lambda s: s.start_ns)[len(ss) - len(want):]
        diffs[thread] += [ts - s.start_ns / 1e3 for s, ts in zip(ss, want)]
    if not diffs:
        return None
    thread = max(diffs, key=lambda t: len(diffs[t]))
    return statistics.median(diffs[thread]), thread


def in_window(trace) -> list[Placed] | None:
    """The program's span records that start in the trace's window, or
    None when it keeps none that pair with the trace."""
    spans = records()
    if not spans:
        return None
    main = [(r.name, r.ts) for r in trace.ranges
            if trace.main_tid is None or r.tid == trace.main_tid]
    placed = offset_us(spans, main)
    if placed is None:
        return None
    off, thread = placed
    lo, hi = trace.window
    return [Placed(s.start_ns / 1e3 + off, s.end_ns / 1e3 + off, s.name,
                   s.nbytes, s.thread != thread)
            for s in spans if lo <= s.start_ns / 1e3 + off <= hi]


def feeder_work(trace, names=("feed.read", "feed.parse", "feed.pack")
                ) -> list[Placed]:
    """The feeder thread's work spans in the window (its waits to put a
    batch on the queue, ``feed.put``, left out)."""
    return [s for s in in_window(trace) or ()
            if s.feeder and s.name in names]


def merged(spans) -> list[tuple[float, float]]:
    """The union of ``spans``' intervals, as sorted disjoint intervals."""
    return _merge(sorted((s.ts, s.end) for s in spans))


def overlap_us(xs, ys) -> float:
    """Time two lists of sorted disjoint intervals share."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def copy_gb_per_s(trace, name: str) -> float | None:
    """The bytes of the tensors copied in the trace's ``name`` ranges
    (the shape of the first ``aten::to`` in each, times
    ``COPY_ITEMSIZE[name]``) over the summed device time of the copies
    launched inside them, in GB (1e9 bytes) a second; None without
    either."""
    copies = [d for d in trace.launched_in((name,)) if d.cat == "gpu_memcpy"]
    nbytes = sum(COPY_ITEMSIZE[name] * math.prod(dims[0])
                 for dims in trace.op_dims(name, "aten::to") if dims)
    seconds = sum(d.end - d.ts for d in copies) * 1e-6
    if not nbytes or not seconds:
        return None
    return nbytes / 1e9 / seconds
