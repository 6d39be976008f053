"""Reads a ``torch.profiler`` Chrome trace into what the per-layer metrics
need: the device's operations, the host's named ranges, and which range
each device operation was launched from.

Times are in microseconds on the trace's own clock.  The window is the
benchmark's ``bench.window`` range; the program's ranges (``extract``,
``count``, ``compact``, ``merge``, ...) and the benchmark's spans
(``bench.job``, ``bench.trim``) are ``user_annotation`` events.  A device
operation (kernel, copy or memset) is tied to its launch by the
``correlation`` id that CUPTI gives both.
"""

from __future__ import annotations

import bisect
import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    ts: float
    end: float
    name: str
    cat: str
    correlation: int | None
    # the event's own arguments (a copy's ``bytes``, ...)
    args: dict = dataclasses.field(default_factory=dict, compare=False,
                                   repr=False)


@dataclasses.dataclass(frozen=True)
class Range:
    ts: float
    end: float
    name: str
    tid: object


def short_name(name: str, limit: int = 100) -> str:
    """A kernel's name without its return type, cut to ``limit``
    characters."""
    name = name[5:] if name.startswith("void ") else name
    return name[:limit]


class Trace:
    """The events of one traced window."""

    def __init__(self, events: list[dict]):
        self.device: list[DeviceOp] = []
        self.ranges: list[Range] = []
        self.launches: dict[int, tuple[float, object]] = {}
        self.ops: list[tuple[float, float, object, str, list]] = []
        for e in events:
            if e.get("ph") != "X" or "ts" not in e:
                continue
            cat = e.get("cat", "")
            ts = float(e["ts"])
            end = ts + float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append(DeviceOp(
                    ts, end, e.get("name", ""), cat, args.get("correlation"),
                    args))
            elif cat == "user_annotation":
                self.ranges.append(Range(ts, end, e.get("name", ""),
                                         e.get("tid")))
            elif cat in LAUNCH_CATS and args.get("correlation") is not None:
                self.launches[args["correlation"]] = (ts, e.get("tid"))
            elif cat == "cpu_op" and args.get("Input Dims") is not None:
                self.ops.append((ts, end, e.get("tid"), e.get("name", ""),
                                 args["Input Dims"]))
        self.device.sort(key=lambda d: d.ts)
        self.ranges.sort(key=lambda r: (r.ts, -r.end))
        self.ops.sort(key=lambda o: o[0])
        self._op_starts = [o[0] for o in self.ops]
        win = self.named(WINDOW)
        if win:
            self.window = (win[0].ts, win[0].end)
            self.main_tid = win[0].tid
        else:
            spans = [d.ts for d in self.device] + [d.end for d in self.device]
            self.window = (min(spans, default=0.0), max(spans, default=0.0))
            self.main_tid = None
        self._by_name: dict[str, tuple[list[float], list[Range]]] = {}
        self._main = [r for r in self.ranges
                      if self.main_tid is None or r.tid == self.main_tid]
        self._main_starts = [r.ts for r in self._main]

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    # --- host ranges --------------------------------------------------------

    def named(self, name: str) -> list[Range]:
        """The ranges called ``name``, in order of start."""
        return [r for r in self.ranges if r.name == name]

    def _index(self, name: str):
        if name not in self._by_name:
            rs = self.named(name)
            self._by_name[name] = ([r.ts for r in rs], rs)
        return self._by_name[name]

    def inside(self, names, t: float, tid=None) -> str | None:
        """The first of ``names`` whose range holds time ``t`` (on thread
        ``tid`` when given), or None."""
        for name in names:
            starts, rs = self._index(name)
            i = bisect.bisect_right(starts, t) - 1
            while i >= 0:
                r = rs[i]
                if tid is None or r.tid == tid:
                    if r.ts <= t <= r.end:
                        return name
                    break  # ranges of one name on one thread do not overlap
                i -= 1
        return None

    def host_label(self, t: float) -> str:
        """The innermost range on the window's thread that holds ``t``."""
        i = bisect.bisect_right(self._main_starts, t) - 1
        while i >= 0:
            if self._main[i].end >= t:
                return self._main[i].name
            i -= 1
        return "outside the window"

    def host_segments(self) -> list[tuple[float, float, str]]:
        """The window cut where a range on its thread starts or ends, each
        piece named by the innermost range that holds it."""
        lo, hi = self.window
        points = sorted({lo, hi, *(t for r in self._main
                                   for t in (r.ts, r.end) if lo < t < hi)})
        return [(a, b, self.host_label((a + b) / 2))
                for a, b in zip(points, points[1:])]

    def union_us(self, names, tid=None) -> list[tuple[float, float]]:
        """The union of the ranges called any of ``names``, as sorted
        disjoint intervals."""
        spans = sorted((r.ts, r.end) for r in self.ranges
                       if r.name in names and (tid is None or r.tid == tid))
        return _merge(spans)

    # --- device operations --------------------------------------------------

    def in_window(self) -> list[DeviceOp]:
        lo, hi = self.window
        return [d for d in self.device if d.end > lo and d.ts < hi]

    def launched_in(self, names) -> list[DeviceOp]:
        """The window's device operations launched while the host was
        inside a range called any of ``names`` (by correlation id)."""
        out = []
        for d in self.in_window():
            at = self.launches.get(d.correlation)
            if at is not None and self.inside(names, at[0], at[1]):
                out.append(d)
        return out

    def kernels(self, name_part: str) -> list[DeviceOp]:
        """The window's kernels whose name holds ``name_part``."""
        return [d for d in self.in_window()
                if d.cat == "kernel" and name_part in d.name]

    def busy(self) -> list[tuple[float, float]]:
        """Disjoint intervals in the window in which the device ran an
        operation."""
        lo, hi = self.window
        return _merge(sorted((max(d.ts, lo), min(d.end, hi))
                             for d in self.in_window()))

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy())

    def idle_gaps(self) -> list[tuple[float, float]]:
        """The window's intervals with nothing on the device."""
        lo, hi = self.window
        gaps, at = [], lo
        for a, b in self.busy():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if hi > at:
            gaps.append((at, hi))
        return gaps

    def op_dims(self, inside: str, prefix: str) -> list[list]:
        """Input dims of the host ops named with ``prefix`` that start in
        a range called ``inside``, the first such op in each range."""
        out = []
        for r in self.named(inside):
            i = bisect.bisect_left(self._op_starts, r.ts)
            while i < len(self.ops) and self.ops[i][0] <= r.end:
                ts, _, tid, name, dims = self.ops[i]
                if tid == r.tid and name.startswith(prefix):
                    out.append(dims)
                    break
                i += 1
        return out


def _merge(spans) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in spans:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the window's idle
    device time by the innermost host range it fell in, each in
    seconds."""
    by_op: dict[str, float] = {}
    for d in trace.in_window():
        key = short_name(d.name) if d.cat == "kernel" else d.name
        by_op[key] = by_op.get(key, 0.0) + (d.end - d.ts) * 1e-6
    idle: dict[str, float] = {}
    segs = trace.host_segments()
    starts = [a for a, _, _ in segs]
    for a, b in trace.idle_gaps():
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            lo, hi, label = segs[i]
            part = min(b, hi) - max(a, lo)
            if part > 0:
                idle[label] = idle.get(label, 0.0) + part * 1e-6
            i += 1
    return {
        "device_ops": sorted(([k, v] for k, v in by_op.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:top],
    }
