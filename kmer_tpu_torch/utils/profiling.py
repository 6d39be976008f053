"""Spans and phase timing, on a clock that maps onto the trace's.

The counterpart of ``kmer_tpu/utils/profiling.py``.  Every span is a
``torch.profiler.record_function`` range, so it shows up by name in a
``torch.profiler`` trace.  While a job records, each span also appends one
record to a ``Profile``: its name, thread, ``perf_counter_ns`` start and
end, the span that holds it, the job's id and a byte count (which also
adds into ``Profile.bytes``).  ``phase_timer`` is a span that also times
its phase, with an optional synchronize, into ``Profile.phases``.

A job is one call of an entry (``count_file``, ``count_batches_pipelined``),
opened by its root span (``entry``).  It records into the ``profile`` the
caller passed, or, while a ``torch.profiler`` records on the calling
thread, into the module's ``TRACED``; otherwise a span costs one
``record_function`` and a flag check.  A span outside any entry (the trim
of a table an entry returned) records into ``TRACED`` while a profiler
records on its thread, under the id of the last job that thread ran.

The feeder thread's ranges do not reach a trace taken by a default
``torch.profiler.profile``: the profiler records the threads it was
started on.  The feeder's records do, and ``trace_offset_us`` places them
on the trace's clock by the main thread's spans, which both hold.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import statistics
import threading
import time

import torch

# records kept a Profile; the oldest go first (a job makes ~100-200)
MAX_SPANS = 1 << 16


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One closed span: ``parent`` is the id of the span that held it
    (None at a job's root), ``job`` the id of its job (None outside any),
    ``thread`` the OS thread id (a trace's ``tid``).  ``start_ns`` is the
    midpoint of two clock readings on either side of the range's own start
    and ``start_err_ns`` half their distance: a wait for the interpreter
    lock on return from the profiler widens it."""

    id: int
    name: str
    thread: int
    start_ns: int
    end_ns: int
    parent: int | None
    job: int | None
    nbytes: int
    start_err_ns: int = 0


class Profile:
    """Accumulates per-phase wall time, byte counts and span records."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self.bytes: dict[str, int] = {}
        self.spans: collections.deque[SpanRecord] = collections.deque(
            maxlen=MAX_SPANS)
        self._lock = threading.Lock()  # the feeder adds beside the main

    def add(self, rec: SpanRecord) -> None:
        with self._lock:
            self.spans.append(rec)
            if rec.nbytes:
                self.bytes[rec.name] = self.bytes.get(rec.name, 0) \
                    + rec.nbytes


# what jobs record into while a torch.profiler records them
TRACED = Profile()

_ids = itertools.count(1)
_local = threading.local()


@dataclasses.dataclass(frozen=True)
class _Job:
    id: int
    profile: Profile | None


@dataclasses.dataclass(frozen=True)
class Context:
    """A thread's open job and innermost recorded span, for another
    thread to take up (``adopt``)."""

    job: _Job | None
    parent: int | None


class _Open:
    """An open span; its ``nbytes`` may be set before it closes."""

    __slots__ = ("nbytes",)

    def __init__(self, nbytes: int):
        self.nbytes = nbytes


def _state():
    st = getattr(_local, "st", None)
    if st is None:
        st = _local.st = _ThreadState()
    return st


class _ThreadState:
    __slots__ = ("job", "last", "stack")

    def __init__(self):
        self.job: _Job | None = None  # the open job
        self.last: _Job | None = None  # the last job this thread ran
        self.stack: list[int] = []  # ids of the open recorded spans


def _recording() -> bool:
    return torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def span(name: str, nbytes: int = 0, profile: Profile | None = None):
    """A ``record_function`` range; while its job records (or into
    ``profile`` when given), also one ``SpanRecord``.  Yields the open
    span, whose ``nbytes`` may be set inside.

    The record's start and end are the midpoints of clock readings taken
    on either side of the range's own: the profiler's work on entering
    and leaving a range falls partly on each side, by an amount that
    depends on the range, and the midpoint cancels most of it."""
    st = _state()
    job = st.job
    if profile is None:
        if job is not None:
            profile = job.profile
        elif _recording():
            profile, job = TRACED, st.last
            if job is not None and job.profile is not TRACED:
                job = None
    if profile is None:
        with torch.profiler.record_function(name):
            yield _Open(nbytes)
        return
    sid = next(_ids)
    parent = st.stack[-1] if st.stack else None
    st.stack.append(sid)
    handle = _Open(nbytes)
    t0 = t1 = time.perf_counter_ns()
    err = 0
    try:
        with torch.profiler.record_function(name):
            err = (time.perf_counter_ns() - t0) // 2
            t0 += err
            try:
                yield handle
            finally:
                t1 = time.perf_counter_ns()
    finally:
        t1 = (t1 + time.perf_counter_ns()) // 2
        st.stack.pop()
        profile.add(SpanRecord(
            sid, name, threading.get_native_id(), t0, t1, parent,
            job.id if job is not None else None, handle.nbytes, err))


@contextlib.contextmanager
def entry(name: str, profile: Profile | None = None):
    """The root span of an entry: opens a job on this thread, which
    records into ``profile``, else into ``TRACED`` while a profiler
    records here, else nowhere.  Inside an open job it is a plain span."""
    st = _state()
    if st.job is not None:
        with span(name):
            yield
        return
    if profile is None and _recording():
        profile = TRACED
    st.job = _Job(next(_ids), profile)
    try:
        with span(name):
            yield
    finally:
        st.last, st.job = st.job, None


def job_entry(fn):
    """Makes ``fn``, which takes a keyword ``profile``, an entry: each
    call runs inside ``entry(fn.__name__, profile)``."""

    @functools.wraps(fn)
    def call(*args, profile: Profile | None = None, **kwargs):
        with entry(fn.__name__, profile):
            return fn(*args, profile=profile, **kwargs)

    return call


def context() -> Context:
    """This thread's job and innermost recorded span."""
    st = _state()
    return Context(st.job, st.stack[-1] if st.stack else None)


@contextlib.contextmanager
def adopt(ctx: Context):
    """Runs this thread's spans in ``ctx``'s job, under its span."""
    st = _state()
    saved = st.job, st.stack
    st.job = ctx.job
    st.stack = [ctx.parent] if ctx.parent is not None else []
    try:
        yield
    finally:
        st.job, st.stack = saved


def synchronize(x) -> None:
    """Waits for the CUDA device of tensor ``x`` (or device ``x``); a CPU
    tensor or device needs no wait."""
    device = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase_timer(profile: Profile | None, name: str, nbytes: int = 0,
                sync=None):
    """A span that times its phase into ``profile.phases``.  With
    ``sync`` (a tensor or a device), the clock starts and stops only after
    that CUDA device has finished its queued work, so the time covers the
    device work."""
    with span(name, nbytes, profile):
        if sync is not None:
            synchronize(sync)
        t0 = time.perf_counter()
        yield
        if sync is not None:
            synchronize(sync)
        dt = time.perf_counter() - t0
    if profile is not None:
        profile.phases[name] = profile.phases.get(name, 0.0) + dt


# --- the trace's clock ------------------------------------------------------


def trace_offset_us(spans, ranges) -> float | None:
    """Microseconds to add to a span's ``start_ns / 1e3`` to put it on a
    trace's clock.

    ``ranges`` are (name, start in us) of the trace's ranges on one
    thread.  On each thread of ``spans``, the spans of each name the trace
    holds, as many as the trace has and the newest (the trace ends the
    record), pair with those ranges in order; the thread with the most
    pairs is the trace's, and the median of its pairs' (range start -
    span start) is the offset.  None when no span pairs with a range.
    """
    by_name: dict[str, list[float]] = collections.defaultdict(list)
    for name, ts in ranges:
        by_name[name].append(float(ts))
    per_thread: dict[tuple[int, str], list[SpanRecord]] = \
        collections.defaultdict(list)
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
    return statistics.median(max(diffs.values(), key=len))


def write_trace(prof, path: str) -> None:
    """Writes the stopped ``torch.profiler`` ``prof``'s Chrome trace to
    ``path`` with the spans of ``TRACED`` that ran on threads the trace
    does not hold (the feeder's) merged in on its clock, each thread under
    its own ``tid``."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("ph") == "X"]
    seen = {e.get("tid") for e in ann}
    spans = list(TRACED.spans)
    roots = {s.thread for s in spans if s.parent is None}
    main = [e for e in ann if e.get("tid") in roots]
    off = trace_offset_us(spans, [(e["name"], e["ts"]) for e in main])
    if off is not None:
        lo = min(e["ts"] for e in main)
        hi = max(e["ts"] + e.get("dur", 0) for e in main)
        events.extend(
            {"ph": "X", "cat": "user_annotation", "name": s.name,
             "pid": main[0].get("pid", 0), "tid": s.thread,
             "ts": s.start_ns / 1e3 + off,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"span": s.id, "parent": s.parent, "job": s.job,
                      "nbytes": s.nbytes}}
            for s in spans if s.thread not in seen
            and lo <= s.start_ns / 1e3 + off <= hi)
    with open(path, "w") as f:
        json.dump(data, f)
