"""The count path's spans (``kmer_tpu_torch.utils.profiling``): what a
CPU ``torch.profiler`` trace holds of them, the records the program keeps
of the feeder thread's, their bytes and job ids, and their alignment with
the trace's clock.  No JAX: the tables are compared with the same count
made with nothing recording."""

import collections
import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kmer_tpu_torch import pipeline
from kmer_tpu_torch.utils import profiling
from kmer_tpu_torch.utils.profiling import Profile, SpanRecord

FOLD = {"extract", "count", "compact", "merge", "merge_runs"}
TRIM = {"trim.select", "trim.copy", "to_numpy"}
FEEDER = {"feed.read", "feed.parse", "feed.pack", "feed.put"}


@pytest.fixture(autouse=True)
def fresh_traced(monkeypatch):
    """Each test starts from an empty module-level record."""
    monkeypatch.setattr(profiling, "TRACED", Profile())


def _fastq(path, n_reads=1500, length=150, seed=1):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i in range(n_reads):
            seq = bases[rng.integers(0, 4, length)].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * length))
    return path


def _fasta(path, n_bases=60000, seed=2):
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n_bases)]
    lines = [seq[i: i + 60].tobytes() for i in range(0, n_bases, 60)]
    with open(path, "wb") as f:
        f.write(b">chr\n" + b"\n".join(lines) + b"\n")
    return path


FILES = {
    # (writer, format, count_file options): a fold of many batches, the
    # whole file in one auto-sized batch, and one record read whole by
    # the probe
    "fastq-fold": (_fastq, "fastq", {"batch": 256, "chunk_bytes": 1 << 16}),
    "fastq-one-batch": (_fastq, "fastq", {"batch": None,
                                          "chunk_bytes": 1 << 16}),
    "fasta-record": (_fasta, "fasta", {"batch": 16, "chunk_bytes": 1 << 14}),
}


def _traced(tmp_path, job):
    """Runs ``job`` under a CPU profiler, as the benchmark's window does;
    returns (its result, the trace's user ranges by thread)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.window"):
            out = job()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ranges[e["tid"]].append((e["name"], e["ts"]))
    return out, ranges


def _check_trace(spans, ranges):
    """Every main-thread record is a range of the trace, in the same
    number a name; ``trace_offset_us`` puts each within 50 us of its
    range, beyond its own reading's error (a wait for the interpreter lock
    while the feeder runs); the feeder's records are not in the trace."""
    main = threading.get_native_id()
    mine = [s for s in spans if s.thread == main]
    held = collections.Counter(n for n, _ in ranges[main])
    have = collections.Counter(s.name for s in mine)
    assert all(held[n] == c for n, c in have.items()), (held, have)
    off = profiling.trace_offset_us(spans, ranges[main])
    assert off is not None
    for name in have:
        starts = sorted(ts for n, ts in ranges[main] if n == name)
        ss = sorted((s for s in mine if s.name == name),
                    key=lambda s: s.start_ns)
        for ts, s in zip(starts, ss):
            assert abs(ts - (s.start_ns / 1e3 + off)) \
                < 50 + s.start_err_ns / 1e3, name
    feeder = {s.thread for s in spans} - {main}
    assert not feeder & set(ranges)


def _check_jobs(spans):
    """One job: every record has its id, and every feeder record has the
    entry's root among its ancestors."""
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None and s.name in (
        "count_file", "count_batches_pipelined")]
    assert len(roots) == 1
    root = roots[0]
    assert {s.job for s in spans} == {root.job}
    main = threading.get_native_id()
    for s in spans:
        if s.thread == main:
            continue
        at = s
        while at.parent is not None:
            at = by_id[at.parent]
        assert at is root, s


def _wire_bytes(path, fmt, k, opts):
    feed, batch, width, _ = pipeline.file_batch_feed(
        path, fmt, k, opts["batch"], None, opts["chunk_bytes"])
    return sum(batch * (width // 16 + 1) * 4 for _ in feed)


@pytest.mark.parametrize("case", sorted(FILES))
def test_count_file_spans(tmp_path, case):
    write, fmt, opts = FILES[case]
    path = write(str(tmp_path / f"in.{fmt}"))
    k = 21
    plain = pipeline.count_file(path, fmt, k, canonical=True, device="cpu",
                                **opts).trim().to_numpy()
    assert not profiling.TRACED.spans  # nothing recording: nothing kept

    def job():
        table = pipeline.count_file(path, fmt, k, canonical=True,
                                    device="cpu", **opts)
        return table.trim().to_numpy()

    lanes, ranges = _traced(tmp_path, job)
    assert all(np.array_equal(a, b) for a, b in zip(plain, lanes))
    spans = list(profiling.TRACED.spans)
    names = {s.name for s in spans}
    want = {"count_file", "feed.probe", "feed.read", "feed.parse",
            "queue.wait", "upload"} | TRIM | FEEDER
    assert want <= names
    assert FOLD <= names and "count_batches_pipelined" in names
    uploads = sum(s.name == "upload" for s in spans)
    assert (uploads == 1) == (opts["batch"] is None)
    _check_trace(spans, ranges)
    _check_jobs(spans)
    main = threading.get_native_id()
    read = [s for s in spans if s.name == "feed.read"]
    assert sum(s.nbytes for s in read if s.thread != main) \
        == os.path.getsize(path)
    assert all(s.thread == main for s in spans if s.name in {
        "feed.probe", "queue.wait", "upload"} | TRIM)
    assert all(s.thread != main for s in spans
               if s.name in ("feed.pack", "feed.put"))
    assert sum(s.nbytes for s in spans if s.name == "upload") \
        == _wire_bytes(path, fmt, k, opts)
    copy = [s for s in spans if s.name == "trim.copy"]
    # the landed columns hold the lanes' bytes: 20 B a row
    assert [s.nbytes for s in copy] == [sum(a.nbytes for a in lanes)]
    assert profiling.TRACED.bytes["upload"] == _wire_bytes(
        path, fmt, k, opts)


def _packed(n_batches=5, rows=128, width=160, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        words = rng.integers(0, 2 ** 32, (rows, width // 16),
                             dtype=np.uint64).astype(np.uint32)
        lens = rng.integers(0, width + 1, rows).astype(np.uint16)
        out.append((words, lens))
    return out


def test_count_batches_pipelined_spans(tmp_path):
    batches = _packed()
    plain = pipeline.count_batches_pipelined(
        batches, 21, canonical=True, device="cpu").trim().to_numpy()
    assert not profiling.TRACED.spans

    def job():
        table = pipeline.count_batches_pipelined(batches, 21, canonical=True,
                                                 device="cpu")
        return table.trim().to_numpy()

    lanes, ranges = _traced(tmp_path, job)
    assert all(np.array_equal(a, b) for a, b in zip(plain, lanes))
    spans = list(profiling.TRACED.spans)
    names = collections.Counter(s.name for s in spans)
    assert names["count_batches_pipelined"] == 1
    assert names["upload"] == names["extract"] == len(batches)
    assert names["queue.wait"] == len(batches) + 1  # and the end
    assert names["feed.pack"] == len(batches)
    assert not names["feed.read"] and not names["feed.probe"]
    _check_trace(spans, ranges)
    _check_jobs(spans)
    wire = sum(w.shape[0] * (w.shape[1] + 1) * 4 for w, _ in batches)
    assert sum(s.nbytes for s in spans if s.name == "upload") == wire
    assert sum(s.nbytes for s in spans if s.name == "feed.pack") == wire
    assert [s.nbytes for s in spans if s.name == "trim.copy"] \
        == [20 * lanes[0].size]
    # upload nests in extract, where the benchmark reads the wire's shape
    by_id = {s.id: s for s in spans}
    assert {by_id[s.parent].name for s in spans if s.name == "upload"} \
        == {"extract"}


def test_a_given_profile_keeps_its_phases_and_the_module_record_nothing(
        tmp_path):
    path = _fastq(str(tmp_path / "in.fastq"), n_reads=600)
    prof = Profile()
    pipeline.count_file(path, "fastq", 15, device="cpu", batch=128,
                        chunk_bytes=1 << 15, profile=prof)
    assert set(prof.phases) == FOLD
    names = {s.name for s in prof.spans}
    assert {"count_file", "feed.probe", "queue.wait", "upload",
            "feed.read", "feed.pack"} <= names
    assert prof.bytes["feed.read"] >= os.path.getsize(path)
    assert {s.job for s in prof.spans} == {prof.spans[0].job}
    assert not profiling.TRACED.spans


def test_spans_outside_an_entry_record_only_under_a_profiler():
    with profiling.span("alone", 5):
        pass
    assert not profiling.TRACED.spans
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("alone", 5) as s:
            s.nbytes += 2
    (rec,) = profiling.TRACED.spans
    assert (rec.name, rec.nbytes, rec.parent) == ("alone", 7, None)
    assert profiling.TRACED.bytes == {"alone": 7}


def test_a_nested_entry_is_a_span_of_the_open_job():
    prof = Profile()
    with profiling.entry("outer", prof):
        with profiling.entry("inner"):
            with profiling.span("leaf"):
                pass
    leaf, inner, outer = prof.spans
    assert leaf.parent == inner.id and inner.parent == outer.id
    assert outer.parent is None
    assert leaf.job == inner.job == outer.job is not None


def test_adopted_context_carries_job_and_parent_to_another_thread():
    prof = Profile()
    with profiling.entry("root", prof):
        ctx = profiling.context()

        def work():
            with profiling.adopt(ctx):
                with profiling.span("there", 3):
                    pass

        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    there, root = prof.spans
    assert there.parent == root.id and there.job == root.job
    assert there.thread != root.thread


def test_the_span_list_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 4)
    prof = Profile()
    for i in range(6):
        with profiling.span(f"s{i}", 1, prof):
            pass
    assert [s.name for s in prof.spans] == ["s2", "s3", "s4", "s5"]
    assert sum(prof.bytes.values()) == 6


def _rec(i, name, thread, start_us, parent=None):
    return SpanRecord(i, name, thread, int(start_us * 1e3),
                      int(start_us * 1e3) + 1000, parent, 1, 0)


def test_trace_offset_us_pairs_the_newest_spans_of_the_traces_thread():
    # the trace clock is the spans' + 250 us; thread 9 (a feeder) has
    # spans of the same names the trace never holds, and thread 1 older
    # spans from before the trace
    spans = [_rec(1, "upload", 1, 10.0), _rec(2, "queue.wait", 1, 20.0)]
    spans += [_rec(10 + i, "upload", 1, 1000.0 + 100 * i) for i in range(3)]
    spans += [_rec(20 + i, "queue.wait", 1, 1050.0 + 100 * i)
              for i in range(3)]
    spans += [_rec(30 + i, "upload", 9, 5000.0 + 7 * i) for i in range(5)]
    ranges = [("upload", 1250.0 + 100 * i + (i % 2)) for i in range(3)]
    ranges += [("queue.wait", 1300.0 + 100 * i) for i in range(3)]
    ranges += [("bench.window", 0.0)]
    assert profiling.trace_offset_us(spans, ranges) == pytest.approx(250.0)
    assert profiling.trace_offset_us(spans, [("other", 1.0)]) is None
    assert profiling.trace_offset_us([], ranges) is None


def test_cli_count_trace_merges_the_feeder_spans(tmp_path, capsys):
    from kmer_tpu_torch.cli import main

    path = _fastq(str(tmp_path / "in.fastq"), n_reads=400)
    out = tmp_path / "trace"
    assert main(["count", "--input", path, "-k", "11", "--canonical",
                 "--batch", "128", "--chunk-mb", "1", "--top", "3",
                 "--device", "cpu", "--trace", str(out)]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 3
    (name,) = os.listdir(out)
    events = json.loads((out / name).read_text())["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    main_tid = threading.get_native_id()
    feeder = [e for e in ann if e["tid"] != main_tid]
    assert {"feed.read", "feed.parse", "feed.pack", "feed.put"} \
        <= {e["name"] for e in feeder}
    assert sum(e["args"]["nbytes"] for e in feeder
               if e["name"] == "feed.read") == os.path.getsize(path)
    root = next(e for e in ann if e["name"] == "count_file")
    assert all(root["ts"] - 50 <= e["ts"] <= root["ts"] + root["dur"] + 50
               for e in feeder)
