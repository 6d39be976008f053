"""The readers of the program's spans (``queue_wait_pct``,
``probe_s_per_job``, ``feed_gb_per_s``, ``feed_idle_pct``,
``h2d_gb_per_s``) on a canned trace and a canned span
list, and nothing where there is nothing to read: a trace without the
ranges or the copies, or a program that keeps no span records.  The
benchmark places the records and counts the copies' bytes itself."""

import dataclasses

import pytest

from benchmark import program_spans, trace as trace_mod
from benchmark.harness import Run
from benchmark.spec import Spec

import tiny

MAIN, FEEDER, DEVICE = 1, 2, 7
OFFSET = -5000.0  # the trace's clock less the spans'


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def canned_events():
    """One job: the routing probe, two waits on the queue, two batches
    of 4 rows x 11 int32 wire columns each uploaded (a 10 us copy) and
    keyed (a 10 us kernel), then the trim (a 30 us copy of 3 x 1000 int64
    lanes to the host)."""
    ev = [_x("user_annotation", "bench.window", 0, 1000),
          _x("user_annotation", "bench.job", 10, 880),
          _x("user_annotation", "count_file", 12, 778),
          _x("user_annotation", "feed.probe", 15, 50)]
    corr = 0

    def launch(at, name, start, dur, cat):
        nonlocal corr
        corr += 1
        ev.append(_x("cuda_runtime", "cudaLaunch", at, 1, correlation=corr))
        ev.append(_x(cat, name, start, dur, tid=DEVICE, correlation=corr))

    for wait, base in ((100, 150), (300, 350)):
        ev.append(_x("user_annotation", "queue.wait", wait, 30 + wait // 30))
        ev.append(_x("user_annotation", "extract", base, 50))
        ev.append(_x("user_annotation", "upload", base + 2, 18))
        ev.append(_x("cpu_op", "aten::to", base + 3, 16,
                     **{"Input Dims": [[4, 11], [], [], [], []]}))
        launch(base + 5, "Memcpy HtoD (Pageable -> Device)", base + 10, 10,
               "gpu_memcpy")
        launch(base + 25, "wire_keys_kernel", base + 30, 10, "kernel")
    ev += [_x("user_annotation", "bench.trim", 800, 90),
           _x("user_annotation", "trim.select", 802, 18),
           _x("user_annotation", "trim.copy", 820, 40),
           _x("cpu_op", "aten::to", 820.5, 39,
              **{"Input Dims": [[3, 1000], [], [], [], []]}),
           _x("user_annotation", "to_numpy", 860, 28)]
    launch(821, "Memcpy DtoH (Device -> Pageable)", 825, 30, "gpu_memcpy")
    return ev


def canned_spans():
    """The program's records of the same job, on its own clock, and the
    feeder thread's, which the trace lacks; plus a record from before the
    window."""
    from kmer_tpu_torch.utils.profiling import SpanRecord

    out = []

    def rec(name, ts, dur, thread=MAIN, parent=1, nbytes=0):
        start = int((ts - OFFSET) * 1e3)
        out.append(SpanRecord(len(out) + 1, name, thread, start,
                              start + int(dur * 1e3), parent, 1, nbytes))

    rec("count_file", 12, 778, parent=None)
    rec("feed.probe", 15, 50, nbytes=65536)
    for wait, base in ((100, 150), (300, 350)):
        rec("queue.wait", wait, 30 + wait // 30)
        rec("extract", base, 50)
        rec("upload", base + 2, 18, nbytes=4 * 11 * 4)
    rec("trim.select", 802, 18, parent=None)
    rec("trim.copy", 820, 40, parent=None, nbytes=24 * 1000)
    rec("to_numpy", 860, 28, parent=None, nbytes=20 * 1000)
    rec("feed.read", 70, 50, FEEDER, nbytes=2_000_000)
    rec("feed.parse", 120, 40, FEEDER, nbytes=2_000_000)
    rec("feed.pack", 160, 40, FEEDER, nbytes=90_000)
    rec("feed.put", 200, 100, FEEDER)
    rec("feed.read", 300, 30, FEEDER, nbytes=1_000_000)
    rec("feed.pack", 330, 20, FEEDER, nbytes=45_000)
    rec("feed.read", -4000, 30, FEEDER, nbytes=7)  # before the window
    return out


# device busy: two uploads, two kernels and the trim's copy
IDLE = 1000 - (4 * 10 + 30)
EXPECTED = {
    "queue_wait_pct": 100 * (33 + 40) / 880,
    "probe_s_per_job": 50e-6,
    # the feeder's 3 MB read over its 180 us of reading, parsing, packing
    "feed_gb_per_s": 3e6 / 1e9 / 180e-6,
    # the feeder works over [70, 200] and [300, 350]; less the device's
    # [160, 170] and [180, 190]
    "feed_idle_pct": 100 * (130 - 20 + 50) / IDLE,
    "h2d_gb_per_s": 2 * 176 / 1e9 / 20e-6,
}
NEW = sorted(EXPECTED)


@pytest.fixture
def traced(monkeypatch):
    from kmer_tpu_torch.utils import profiling

    prof = profiling.Profile()
    for s in canned_spans():
        prof.add(s)
    monkeypatch.setattr(profiling, "TRACED", prof)
    return prof


def _run(events):
    return Run(trace=trace_mod.Trace(events), k=21,
               jobs=[{"trim_s": 0.1, "batches": 2}], batches=2,
               hbm_bytes_per_s=1e10)


def _read(name, run):
    spec = Spec()
    metric = next(m for m in spec.data["per_layer"] if m["name"] == name)
    return spec.reader(metric)(run)


@pytest.mark.parametrize("name", NEW)
def test_reader_on_canned_trace_and_spans(name, traced):
    assert _read(name, _run(canned_events())) == pytest.approx(
        EXPECTED[name], rel=1e-9)


# what each reader lacks in a trace with nothing for it to read
EMPTY = {
    "queue_wait_pct": lambda e: e["name"] != "queue.wait",
    "probe_s_per_job": lambda e: e["name"] != "feed.probe",
    "feed_gb_per_s": lambda e: True,  # with no span records, below
    "feed_idle_pct": lambda e: e["cat"] == "user_annotation",
    "h2d_gb_per_s": lambda e: e["cat"] == "user_annotation",
}


@pytest.mark.parametrize("name", NEW)
def test_reader_silent_with_nothing_to_read(name, traced):
    if name == "feed_gb_per_s":
        traced.spans.clear()
    events = [e for e in canned_events() if EMPTY[name](e)]
    assert _read(name, _run(events)) is None


# the readers of the program's records; the others read the trace alone
FROM_RECORDS = {"feed_gb_per_s", "feed_idle_pct"}


@pytest.mark.parametrize("name", NEW)
def test_reader_on_a_program_without_span_records(name, monkeypatch):
    # a program without span records: utils.profiling has no TRACED
    from kmer_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "TRACED")
    want = None if name in FROM_RECORDS else pytest.approx(EXPECTED[name])
    assert _read(name, _run(canned_events())) == want


@pytest.mark.parametrize("name", NEW)
def test_reader_owns_its_yardstick(name, monkeypatch):
    # the records' own offset function, parents and copy bytes are not
    # read: the benchmark places the records and counts the copies itself
    from kmer_tpu_torch.utils import profiling

    prof = profiling.Profile()
    for s in canned_spans():
        prof.add(dataclasses.replace(
            s, parent=None,
            nbytes=s.nbytes if s.name.startswith("feed.") else 1))
    monkeypatch.setattr(profiling, "TRACED", prof)
    monkeypatch.setattr(profiling, "trace_offset_us",
                        lambda *a: pytest.fail("the program's offset"),
                        raising=False)
    assert _read(name, _run(canned_events())) == pytest.approx(
        EXPECTED[name], rel=1e-9)


def test_offset_pairs_the_newest_records_of_the_traces_thread():
    # the trace clock is the records' + 250 us; thread 9 (a feeder) has
    # records of the same names the trace never holds, and thread 1 older
    # records from before the trace
    from kmer_tpu_torch.utils.profiling import SpanRecord

    def rec(i, name, thread, start_us):
        return SpanRecord(i, name, thread, int(start_us * 1e3),
                          int(start_us * 1e3) + 1000, None, 1, 0)

    spans = [rec(1, "upload", 1, 10.0), rec(2, "queue.wait", 1, 20.0)]
    spans += [rec(10 + i, "upload", 1, 1000.0 + 100 * i) for i in range(3)]
    spans += [rec(20 + i, "queue.wait", 1, 1050.0 + 100 * i)
              for i in range(3)]
    spans += [rec(30 + i, "upload", 9, 5000.0 + 7 * i) for i in range(5)]
    ranges = [("upload", 1250.0 + 100 * i + (i % 2)) for i in range(3)]
    ranges += [("queue.wait", 1300.0 + 100 * i) for i in range(3)]
    ranges += [("bench.window", 0.0)]
    off, thread = program_spans.offset_us(spans, ranges)
    assert (off, thread) == (pytest.approx(250.0), 1)
    assert program_spans.offset_us(spans, [("other", 1.0)]) is None
    assert program_spans.offset_us([], ranges) is None


def test_the_new_metrics_are_declared_for_their_cells():
    spec = tiny.spec()  # the packed cell is kept in spare.json for now
    per = {m["name"]: m for m in spec.data["per_layer"]}
    assert set(NEW) <= set(per)
    for name in NEW:
        assert per[name]["moves"] == "kmers_per_s"
    no_probe = {"probe_s_per_job", "feed_gb_per_s"}
    for name in NEW:
        cells = set(per[name]["workloads"])
        assert ("scer-wgs-k21.packed" in cells) == (name not in no_probe)
