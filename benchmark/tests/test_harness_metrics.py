"""Each per-layer metric's reader gives its number on a small canned
trace, and nothing where its trace holds nothing to read."""

import glob
import importlib
import json
import os

import pytest

from benchmark import trace as trace_mod
from benchmark.harness import Run
from benchmark.spec import Spec

MAIN = 1


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def canned_events():
    """One job of two batches of 4 rows x 11 wire columns (width 160):
    per batch a wire -> keys kernel, two sort kernels and the segment
    counts under ``count``, a merge kernel and a copy under ``compact``
    and ``merge``; then the trim."""
    ev = [_x("user_annotation", "bench.window", 0, 1000),
          _x("user_annotation", "bench.job", 10, 890),
          _x("user_annotation", "bench.trim", 800, 90)]
    corr = 0

    def launch(at, kernel, start, dur, cat="kernel"):
        nonlocal corr
        corr += 1
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", at, 1,
                     correlation=corr))
        ev.append(_x(cat, kernel, start, dur, tid=7, correlation=corr))

    for b, base in enumerate((100, 400)):
        ev.append(_x("user_annotation", "extract", base, 20))
        ev.append(_x("cpu_op", "aten::to", base + 1, 5,
                     **{"Input Dims": [[4, 11], [], [], [], []]}))
        launch(base + 10, "wire_keys_kernel", base + 12, 2)
        ev.append(_x("user_annotation", "count", base + 20, 40))
        launch(base + 25, "void at_cuda_detail::cub::DeviceRadixSortOnesweep"
               "Kernel<int>(int)", base + 30, 4)
        launch(base + 26, "void at_cuda_detail::cub::DeviceRadixSortHistogram"
               "Kernel<int>(int)", base + 34, 2)
        launch(base + 27, "segment_counts_kernel(Args)", base + 36, 1)
        ev.append(_x("user_annotation", "compact", base + 60, 20))
        launch(base + 61, "void at::native::index_elementwise_kernel<1>()",
               base + 62, 3)
        ev.append(_x("user_annotation", "merge", base + 80, 20))
        launch(base + 81, "Memcpy DtoD (Device -> Device)", base + 82, 5,
               cat="gpu_memcpy")
    launch(805, "Memcpy DtoH (Device -> Pageable)", 806, 50,
           cat="gpu_memcpy")
    return ev


def _run(events, hbm=1e10, k=21):
    tr = trace_mod.Trace(events)
    jobs = [{"trim_s": 0.25, "batches": 2}, {"trim_s": 0.75, "batches": 2}]
    return Run(trace=tr, k=k, jobs=jobs, batches=4, hbm_bytes_per_s=hbm)


def _read(name, run):
    spec = Spec()
    metric = next(m for m in spec.data["per_layer"] if m["name"] == name)
    return spec.reader(metric)(run)


SLOTS = 4 * (160 - 21 + 1)  # a batch's window slots

EXPECTED = {
    # bytes / (summed kernel us) / peak, in percent
    "wire_keys_roofline": 100 * 2 * (4 * 11 * 4 + SLOTS * 9) / 4e-6 / 1e10,
    "sort_roofline": 100 * 2 * SLOTS * 16 / 12e-6 / 1e10,
    "segment_counts_roofline": 100 * 2 * SLOTS * 12 / 2e-6 / 1e10,
    # (3 + 5) us a batch under compact and merge
    "merge_ms_per_batch": 2 * 8e-3 / 4,
    "trim_s_per_job": 0.5,
    # device busy 2+4+2+1+3+5 twice and 50 of 1000 us
    "device_idle_pct": 100 * (1 - (2 * 17 + 50) / 1000),
    # the job's 890 us less the ranges (2 x 100) and the trim (90)
    "feed_wait_pct": 100 * (890 - 200 - 90) / 890,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_reads_canned_trace(name, tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": canned_events()}))
    run = _run(trace_mod.Trace.load(str(path)).device and canned_events())
    assert _read(name, run) == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(set(EXPECTED) - {"trim_s_per_job"}))
def test_metric_silent_on_a_trace_with_nothing_to_read(name):
    # a CPU-only trace: the ranges, no device operation and no launch
    events = [e for e in canned_events()
              if e["cat"] in ("user_annotation",) and e["name"] != "bench.job"]
    assert _read(name, _run(events)) is None


def test_every_per_layer_metric_has_a_reader_and_a_canned_reading():
    # a canned reading is an entry of the ``EXPECTED`` of some test file
    # here, which that file's tests read from a canned trace: a metric
    # added later brings its reader and a test file of its own
    spec = Spec()
    canned = set()
    for path in glob.glob(os.path.join(os.path.dirname(__file__),
                                       "test_*.py")):
        name = os.path.splitext(os.path.basename(path))[0]
        canned |= set(getattr(importlib.import_module(name), "EXPECTED", {}))
    for m in spec.data["per_layer"]:
        assert callable(spec.reader(m)), m["name"]
        assert m["name"] in canned, m["name"]


def test_breakdown_names_ops_and_idle_by_host_range():
    tr = trace_mod.Trace(canned_events())
    b = trace_mod.breakdown(tr)
    ops = dict(b["device_ops"])
    assert ops["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(50e-6)
    assert any(name.startswith("at_cuda_detail::cub::DeviceRadixSort")
               for name in ops)
    idle = dict(b["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(
        1e-6 * (1000 - 2 * 17 - 50))
    assert "bench.trim" in idle and "count" in idle
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
