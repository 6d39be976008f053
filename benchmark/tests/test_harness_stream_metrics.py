"""The readers of the landing's copy rate and the codes -> keys kernel's
roofline (``landing_gb_per_s``, ``codes_keys_roofline``) on a canned
trace of a stream's jobs, and nothing where there is nothing to read."""

import pytest

from benchmark import trace as trace_mod
from benchmark.harness import Run
from benchmark.spec import Spec

MAIN, WRITER, DEVICE = 1, 3, 7
K, ROWS, BASES = 21, 4, 150


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def canned_events():
    """Two code batches [4, 150] (one a job, as ``JOBS``), each keyed by
    one 3 us ``codes_keys`` launch; a checkpoint's copy to the host
    launched by the writer thread during the trim and one launched on the
    main thread before it; then the trim, whose landing copies 1 MB and
    0.5 MB to pinned memory in 20 and 10 us."""
    ev = [_x("user_annotation", "bench.window", 0, 1000),
          _x("user_annotation", "bench.job", 10, 880),
          _x("user_annotation", "bench.trim", 790, 95),
          _x("user_annotation", "trim.select", 792, 8),
          _x("user_annotation", "trim.copy", 800, 60),
          _x("user_annotation", "to_numpy", 860, 20)]
    corr = 0

    def launch(at, name, start, dur, cat, tid=MAIN, **args):
        nonlocal corr
        corr += 1
        ev.append(_x("cuda_runtime", "cudaLaunch", at, 1, tid=tid,
                     correlation=corr))
        ev.append(_x(cat, name, start, dur, tid=DEVICE, correlation=corr,
                     **args))

    for base in (100, 300):
        launch(base, "codes_keys_kernel(unsigned char const*, long long)",
               base + 2, 3, "kernel")
    launch(500, "Memcpy DtoH (Device -> Pageable)", 502, 40, "gpu_memcpy",
           bytes=9_000_000)
    launch(801, "Memcpy DtoH (Device -> Pageable)", 803, 30, "gpu_memcpy",
           tid=WRITER, bytes=7_000_000)
    launch(805, "Memcpy DtoH (Device -> Pinned)", 806, 20, "gpu_memcpy",
           bytes=1_000_000)
    launch(830, "Memcpy DtoH (Device -> Pinned)", 831, 10, "gpu_memcpy",
           bytes=500_000)
    launch(845, "Memset (Device)", 846, 2, "gpu_memset", bytes=64)
    return ev


JOBS = [{"trim_s": 0.1, "batches": 1, "codes_shape": [ROWS, BASES]},
        {"trim_s": 0.1, "batches": 1, "codes_shape": [ROWS, BASES]}]
# the halo'd codes, a 4-byte length a row, 9 bytes a slot, per launch
LAUNCH_BYTES = ROWS * (BASES + K - 1) + 4 * ROWS + ROWS * BASES * 9
EXPECTED = {
    "landing_gb_per_s": 1.5e6 / 1e9 / 30e-6,
    "codes_keys_roofline": 100 * 2 * LAUNCH_BYTES / 6e-6 / 1e10,
}
NAMES = sorted(EXPECTED)


def _run(events, jobs=JOBS):
    return Run(trace=trace_mod.Trace(events), k=K, jobs=jobs,
               batches=sum(j["batches"] for j in jobs), hbm_bytes_per_s=1e10)


def _read(name, run):
    # by name: ``codes_keys_roofline`` waits for its cell (PERF.md §7)
    return Spec().reader({"name": name})(run)


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_canned_trace(name):
    assert _read(name, _run(canned_events())) == pytest.approx(
        EXPECTED[name], rel=1e-9)


# a trace, or jobs, with nothing for each reader to read
EMPTY = {
    # the landing's copies without their bytes, or without the range
    "landing_gb_per_s": [
        ([{**e, "args": {k: v for k, v in e["args"].items() if k != "bytes"}}
          for e in canned_events()], JOBS),
        ([e for e in canned_events() if e["name"] != "trim.copy"], JOBS)],
    # no launch, or launches that do not pair with the batches fed
    "codes_keys_roofline": [
        ([e for e in canned_events() if e["cat"] != "kernel"], JOBS),
        (canned_events(), [{**j, "batches": 3} for j in JOBS])],
}


@pytest.mark.parametrize("name,case", [(n, i) for n in NAMES
                                       for i in range(len(EMPTY[n]))])
def test_reader_silent_with_nothing_to_read(name, case):
    events, jobs = EMPTY[name][case]
    assert _read(name, _run(events, jobs)) is None


def test_event_args_kept_beside_correlation():
    tr = trace_mod.Trace(canned_events())
    copies = [d for d in tr.device if d.cat == "gpu_memcpy"]
    assert [d.args["bytes"] for d in copies] == [
        9_000_000, 7_000_000, 1_000_000, 500_000]
    assert all(d.correlation == d.args["correlation"] for d in tr.device)
