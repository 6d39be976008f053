"""The port's streaming fold (count_batches_pipelined, count_file,
checkpoints, spills, the CLI flags) vs kmer_tpu's, on the
CPU.  Tables are compared exactly: keys, lengths and 64-bit counts; error
strings are compared whole.  The case list follows tests/test_pipeline.py.
"""

import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

import kmer_tpu.pipeline as jp
from kmer_tpu_torch import pipeline
from kmer_tpu_torch.ops.wide import WideCounts
from kmer_tpu_torch.pipeline import (
    PipelineCheckpoint, count_batches_pipelined, count_file, file_batch_feed)
from kmer_tpu_torch.utils.logging import StatsCounters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUT = "acgt"


def _oracle(codes, lens, k) -> Counter:
    c = Counter()
    for r in range(codes.shape[0]):
        s = "".join(LUT[x] for x in codes[r, : lens[r]])
        for i in range(len(s) - k + 1):
            c[s[i: i + k]] += 1
    return c


def _batches(seed, n_batches=5, B=48, W=32, k=5):
    rng = np.random.default_rng(seed)
    batches, oracle = [], Counter()
    for _ in range(n_batches):
        codes = rng.integers(0, 4, (B, W), dtype=np.uint8)
        lens = rng.integers(0, W + 1, B).astype(np.int32)
        oracle.update(_oracle(codes, lens, k))
        batches.append((codes, lens))
    return batches, oracle


def _copies(batches):
    return iter([(c.copy(), ln.copy()) for c, ln in batches])


def _write_fastq(path, seed, n_reads, lmin=10, lmax=120):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n_reads):
            s = "".join("ACGT"[c] for c in rng.integers(
                0, 4, int(rng.integers(lmin, lmax))))
            f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")


def _assert_same(got, want):
    """Trimmed port WideCounts == kmer_tpu's table (either kind)."""
    t, w = got.trim(), want.trim()
    hi, lo, length, _, _ = t.to_numpy()
    counts = t.counts64()
    np.testing.assert_array_equal(hi, np.asarray(w.hi, np.uint32))
    np.testing.assert_array_equal(lo, np.asarray(w.lo, np.uint32))
    np.testing.assert_array_equal(length, np.asarray(w.length, np.int32))
    want_counts = (w.counts64() if hasattr(w, "counts64")
                   else np.asarray(w.counts, np.int64))
    np.testing.assert_array_equal(counts, want_counts)


@pytest.mark.parametrize("fmt, k, canonical", [
    ("fastq", 21, True), ("fasta", 32, False), ("fastq", 7, False)])
def test_count_file_fold_matches_kmer_tpu(tmp_path, fmt, k, canonical):
    path = str(tmp_path / f"r.{fmt}")
    rng = np.random.default_rng(k)
    with open(path, "w") as f:
        for i in range(300):
            s = "".join("ACGT"[c] for c in rng.integers(
                0, 4, int(rng.integers(1, 150))))
            if i % 50 == 0:
                s = "T" * 40  # all-t reads: at k = 32 the sentinel's bits
            f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" if fmt == "fastq"
                    else f">r{i}\n{s}\n")
    want = jp.count_file(path, fmt, k, canonical=canonical, batch=64,
                         single_shot=False)
    got = count_file(path, fmt, k, canonical=canonical, batch=64,
                     device="cpu")
    assert isinstance(got, WideCounts)
    _assert_same(got, want)
    assert got.distinct() == int(want.n_unique)


def test_both_routes_agree(tmp_path):
    """A small file folds in one auto-sized batch, to the table of many
    batches and of kmer_tpu."""
    path = str(tmp_path / "r.fastq")
    _write_fastq(path, 10, 400)
    stats = StatsCounters()
    got = count_file(path, "fastq", 9, canonical=True, stats=stats,
                     device="cpu")
    assert isinstance(got, WideCounts) and stats.batches == 1
    many = count_file(path, "fastq", 9, canonical=True, batch=64,
                      device="cpu")
    assert got.to_dict() == many.to_dict()
    want = jp.count_file(path, "fastq", 9, canonical=True, batch=64)
    _assert_same(got, want)
    assert got.distinct() == many.distinct() == int(want.n_unique)


def test_pipelined_exact_and_growth_from_16():
    batches, oracle = _batches(1, k=8, n_batches=6)
    res = count_batches_pipelined(_copies(batches), 8, capacity=16,
                                  device="cpu")
    assert res.to_dict() == dict(oracle)
    assert res.capacity >= len(oracle)
    want = jp.count_batches_pipelined(_copies(batches), 8, capacity=16,
                                      sample_every=2, runahead=3)
    _assert_same(res, want)


def test_growth_only_grows_in_powers_of_two(monkeypatch):
    """Capacity starts at a power of two and only grows: the batch that
    fills it past grow_threshold takes it to the next one."""
    batches, oracle = _batches(16, k=8, n_batches=10, B=48, W=40)
    caps = []
    real = pipeline._PipelineRun.fold

    def fold(run, idx, wire):
        real(run, idx, wire)
        caps.append(run.cap)

    monkeypatch.setattr(pipeline._PipelineRun, "fold", fold)
    res = count_batches_pipelined(_copies(batches), 8, capacity=100,
                                  grow_threshold=0.5, device="cpu")
    assert caps[0] >= 128 and caps == sorted(caps) and len(set(caps)) > 1
    assert all(c & (c - 1) == 0 for c in caps)
    assert res.capacity == caps[-1] and res.to_dict() == dict(oracle)


@pytest.mark.parametrize("to_dir", [False, True])
def test_spill_exact(tmp_path, to_dir):
    batches, oracle = _batches(2, k=8, n_batches=6, B=64, W=48)
    per_batch = max(len(_oracle(c, ln, 8)) for c, ln in batches)
    cap = 1 << int(per_batch).bit_length()  # one batch fits
    assert cap < len(oracle)  # the union does not: spills must happen
    sd = str(tmp_path / "spills") if to_dir else None
    from kmer_tpu_torch.utils.profiling import Profile

    stats, profile = StatsCounters(), Profile()
    res = count_batches_pipelined(_copies(batches), 8, capacity=cap,
                                  max_capacity=cap, spill_dir=sd,
                                  stats=stats, profile=profile, device="cpu")
    assert stats.spills > 0 and stats.batches == 6
    assert {"extract", "count", "compact", "merge", "spill",
            "merge_runs"} == set(profile.phases)
    assert res.to_dict() == dict(oracle)
    want = jp.count_batches_pipelined(_copies(batches), 8, capacity=cap,
                                      max_capacity=cap, sample_every=2)
    _assert_same(res, want)
    if to_dir:
        assert len(os.listdir(sd)) == stats.spills


def test_oversize_batch_raises_kmer_tpu_message():
    batches, _ = _batches(3, k=8, n_batches=2, B=64, W=48)
    with pytest.raises(ValueError) as want:
        jp.count_batches_pipelined(_copies(batches), 8, capacity=16,
                                   max_capacity=256, sample_every=2)
    with pytest.raises(ValueError) as got:
        count_batches_pipelined(_copies(batches), 8, capacity=16,
                                max_capacity=256, device="cpu")
    assert str(got.value) == str(want.value)
    assert "max_capacity is 256" in str(got.value)


def test_column_feed_through_the_fold_matches_kmer_tpu():
    """In-memory dna strings (one far longer than the width cap, split
    with a k-1 overlap) through column_batch_feed and the fold."""
    from kmer_tpu_torch.pipeline import column_batch_feed

    rng = np.random.default_rng(8)
    seqs = ["".join(LUT[c] for c in rng.integers(0, 4, int(n)))
            for n in rng.integers(1, 200, 120)]
    seqs[60] = "".join(LUT[c] for c in rng.integers(0, 4, 20_000))
    feed, batch, width = column_batch_feed(seqs, 9, batch=64, width_cap=1024)
    jfeed, jbatch, jwidth = jp.column_batch_feed(seqs, 9, batch=64,
                                                 width_cap=1024)
    assert (batch, width) == (jbatch, jwidth) == (64, 1024)
    res = count_batches_pipelined(feed, 9, capacity=1 << 12, device="cpu")
    oracle = Counter(s[i: i + 9] for s in seqs
                     for i in range(len(s) - 8))
    assert res.to_dict() == dict(oracle)
    _assert_same(res, jp.count_batches_pipelined(jfeed, 9, capacity=1 << 12,
                                                 sample_every=2))


def test_max_slots_non_pow2_clamps():
    batches, oracle = _batches(17, k=5, n_batches=3)
    res = count_batches_pipelined(_copies(batches), 5, capacity=3_000_000,
                                  max_capacity=3_000_000, device="cpu")
    assert res.to_dict() == dict(oracle)
    assert res.capacity <= 1 << 21  # the budget rounded down


def test_empty_stream_and_shape_change_raise():
    with pytest.raises(ValueError, match="empty batch stream"):
        count_batches_pipelined(iter([]), 5, device="cpu")
    (c0, l0), (c1, l1) = _batches(4, n_batches=2)[0]
    with pytest.raises(ValueError, match="one fixed batch shape"):
        count_batches_pipelined(iter([(c0, l0), (c1[:5], l1[:5])]), 5,
                                device="cpu")


def _error(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_resume_flag_mismatch_rejected_with_kmer_tpu_message(tmp_path):
    batches, _ = _batches(18, k=5, n_batches=4)
    msgs = []
    for pkg, kw in ((jp, {"sample_every": 1}), (pipeline, {"device": "cpu"})):
        ck = str(tmp_path / "ck.npz")
        if os.path.exists(ck):
            os.unlink(ck)
        pkg.count_batches_pipelined(
            _copies(batches[:2]), 5, capacity=1 << 12,
            ckpt=pkg.PipelineCheckpoint(ck), ckpt_every_s=0.0, **kw)
        msgs.append(_error(lambda: pkg.count_batches_pipelined(
            _copies(batches), 6, capacity=1 << 12,
            ckpt=pkg.PipelineCheckpoint(ck), **kw)))
    assert msgs[0] == msgs[1]
    assert "was written with k=5; this resume uses k=6" in msgs[1]


def test_ckpt_with_ram_spill_rejected_with_kmer_tpu_message(tmp_path):
    batches, _ = _batches(13, k=8, n_batches=2)
    ck = str(tmp_path / "ck.npz")
    want = _error(lambda: jp.count_batches_pipelined(
        _copies(batches), 8, capacity=16, max_capacity=1024,
        ckpt=jp.PipelineCheckpoint(ck)))
    got = _error(lambda: count_batches_pipelined(
        _copies(batches), 8, capacity=16, max_capacity=1024,
        ckpt=PipelineCheckpoint(ck), device="cpu"))
    assert got == want and "needs spill_dir" in got


def _partial(pkg, feed_batches, ck, n, **kw):
    extra = {"device": "cpu"} if pkg is pipeline else {"sample_every": 2}
    pkg.count_batches_pipelined(iter(feed_batches[:n]), 7,
                                capacity=1 << 12,
                                ckpt=pkg.PipelineCheckpoint(ck),
                                ckpt_every_s=0.0, **kw, **extra)


@pytest.mark.parametrize("writer", ["kmer_tpu", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """A checkpoint written by one package resumes in the other to the
    straight run's table."""
    path = str(tmp_path / "r.fastq")
    _write_fastq(path, 6, 800)
    feed, _, width, _ = file_batch_feed(path, "fastq", 7, 64, None)
    batches = list(feed)
    ck = str(tmp_path / "ck.npz")
    straight = jp.count_file(path, "fastq", 7, batch=64, capacity=1 << 12,
                             single_shot=False)
    if writer == "kmer_tpu":
        _partial(jp, batches, ck, 5)
        pc = PipelineCheckpoint(ck)
        assert 0 < pc.batches_done <= 5 and pc.meta["width"] == width
        res = count_file(path, "fastq", 7, batch=64, width=width,
                         capacity=1 << 12, ckpt_path=ck, device="cpu")
    else:
        _partial(pipeline, batches, ck, 5)
        pc = jp.PipelineCheckpoint(ck)
        assert pc.batches_done == 5
        assert {"batches_done", "capacity", "spill_runs", "k", "canonical",
                "batch", "width"} <= set(pc.meta)
        res = jp.count_file(path, "fastq", 7, batch=64, width=width,
                            capacity=1 << 12, ckpt_path=ck).trim()
        res = WideCounts.from_numpy(*(np.asarray(a) for a in (
            res.hi, res.lo, res.length, res.counts_hi, res.counts_lo)))
    _assert_same(res, straight)
    assert PipelineCheckpoint(ck).batches_done == len(batches)


def test_ckpt_spill_resume_carries_runs(tmp_path):
    path = str(tmp_path / "r.fastq")
    _write_fastq(path, 14, 900, lmin=30, lmax=90)
    sd = str(tmp_path / "runs")
    ck = str(tmp_path / "ck.npz")
    feed, _, _, _ = file_batch_feed(path, "fastq", 8, 64, None)
    batches = list(feed)
    cap = 1 << 12  # one batch fits, the file does not
    kw = dict(capacity=cap, max_capacity=cap, spill_dir=sd, device="cpu")
    straight = count_batches_pipelined(iter(batches), 8, **kw)
    assert isinstance(straight.keys.numpy(), np.ndarray)
    count_batches_pipelined(iter(batches[: len(batches) // 2]), 8,
                            ckpt=PipelineCheckpoint(ck), ckpt_every_s=0.0,
                            **kw)
    pc = PipelineCheckpoint(ck)
    assert pc.batches_done == len(batches) // 2 and pc.spill_runs
    res = count_batches_pipelined(iter(batches), 8,
                                  ckpt=PipelineCheckpoint(ck),
                                  ckpt_every_s=0.0, **kw)
    assert res.to_dict() == straight.to_dict()
    want = jp.count_batches_pipelined(iter(batches), 8, capacity=cap,
                                      max_capacity=cap, sample_every=2)
    _assert_same(res, want)


def test_undershot_estimate_falls_back_to_the_fold(tmp_path):
    """The fold is the one route, whatever the estimate:
    ``single_shot=True`` raises, and False counts as None does."""
    path = str(tmp_path / "r.fastq")
    _write_fastq(path, 21, 300, lmin=1, lmax=150)
    kw = dict(canonical=True, batch=16, width=160, device="cpu")
    with pytest.raises(ValueError, match="one route"):
        count_file(path, "fastq", 21, single_shot=True, **kw)
    got = count_file(path, "fastq", 21, single_shot=False, **kw)
    assert got.to_dict() == count_file(path, "fastq", 21, **kw).to_dict()
    _assert_same(got, jp.count_file(path, "fastq", 21, canonical=True,
                                    batch=16, width=160))


def _cli(args):
    return subprocess.run(
        [sys.executable, "-m", "kmer_tpu_torch", "count", *args, "--device",
         "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("flags", [
    ["--max-slots", "6000", "--spill-dir", "SPILL"],
    ["--slots", "64", "--ckpt", "CKPT"],
])
def test_cli_fold_flags_match_kmer_tpu(tmp_path, capsys, flags):
    from kmer_tpu.cli import main as jax_main

    path = str(tmp_path / "r.fastq")
    _write_fastq(path, 9, 300, lmin=20, lmax=120)
    args = ["--input", path, "-k", "9", "--canonical", "--batch", "64",
            "--top", "0"]

    def place(which):
        return [str(tmp_path / f"{which}-{f}") if f in ("SPILL", "CKPT")
                else f for f in flags]

    assert jax_main(["count", *args, *place("jax")]) == 0
    want = capsys.readouterr()
    got = _cli([*args, *place("port")])
    assert got.returncode == 0, got.stderr
    assert got.stdout == want.out
    summary = [ln for ln in got.stderr.splitlines() if ln.startswith("# ")]
    assert summary == [ln for ln in want.err.splitlines()
                       if ln.startswith("# ")]
    if "--spill-dir" in flags:
        assert os.listdir(tmp_path / "port-SPILL")


def test_cli_streaming_save_loads_in_kmer_tpu(tmp_path):
    from kmer_tpu.parallel.streaming import load_wide as jax_load_wide

    from kmer_tpu_torch.parallel.streaming import load_wide

    path = str(tmp_path / "r.fastq")
    _write_fastq(path, 4, 200, lmin=20, lmax=80)
    out = str(tmp_path / "t.npz")
    got = _cli(["--input", path, "-k", "11", "--canonical", "--max-slots",
                "65536", "--batch", "64", "--save", out])
    assert got.returncode == 0, got.stderr
    jacc, meta = jax_load_wide(out)
    assert meta == {"version": 2, "k": 11, "canonical": True}
    acc, meta2 = load_wide(out)
    assert meta2 == meta
    want = count_file(path, "fastq", 11, canonical=True, device="cpu")
    assert jacc.to_dict() == acc.to_dict() == want.to_dict()
    _assert_same(acc, jacc)


def test_save_wide_round_trips_both_ways(tmp_path):
    """save_wide/load_wide in either package read the other's file, live
    rows and 64-bit counts included (v2, and v1 full-capacity files)."""
    import jax.numpy as jnp
    import kmer_tpu.ops.wide as jw
    from kmer_tpu.parallel.streaming import load_wide as jax_load_wide
    from kmer_tpu.parallel.streaming import save_wide as jax_save_wide
    from kmer_tpu.utils.checkpoint import atomic_savez

    from kmer_tpu_torch.parallel.streaming import load_wide, save_wide

    big = 5_000_000_000
    lanes = (np.asarray([7, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF], np.uint32),
             np.asarray([0, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF], np.uint32),
             np.asarray([32, 32, 0x7FFFFFFF, 0x7FFFFFFF], np.int32),
             np.asarray([big >> 32, 0, 0, 0], np.int32),
             np.asarray([big & 0xFFFFFFFF, 3, 0, 0], np.uint32))
    acc = WideCounts.from_numpy(*lanes)  # the all-t 32-mer is a live row
    save_wide(acc, str(tmp_path / "port.npz"), {"k": 32})
    jacc, meta = jax_load_wide(str(tmp_path / "port.npz"))
    assert meta == {"version": 2, "k": 32}
    for got, want in zip((jacc.hi, jacc.lo, jacc.length, jacc.counts_hi,
                          jacc.counts_lo), lanes):
        np.testing.assert_array_equal(np.asarray(got), want)
    jax_save_wide(jw.WideCounts(*(jnp.asarray(x) for x in lanes),
                                n_unique=jnp.asarray(2, jnp.int32)),
                  str(tmp_path / "jax.npz"), {"k": 32})
    back, _ = load_wide(str(tmp_path / "jax.npz"))
    for got, want in zip(back.to_numpy(), lanes):
        np.testing.assert_array_equal(got, want)
    assert back.distinct() == 2 and back.trim().counts64().tolist() == [big, 3]
    atomic_savez(str(tmp_path / "v1.npz"), hi=lanes[0], lo=lanes[1],
                 length=lanes[2], counts_hi=lanes[3], counts_lo=lanes[4],
                 n_unique=np.int64(2), meta='{"version": 1}')
    v1, _ = load_wide(str(tmp_path / "v1.npz"))
    for got, want in zip(v1.to_numpy(), lanes):
        np.testing.assert_array_equal(got, want)


def test_feeder_is_stopped_when_the_fold_raises():
    """An error mid-run stops the producer: its thread ends instead of
    staying blocked on a full queue."""
    import threading

    batches, _ = _batches(3, k=8, n_batches=8, B=64, W=48)
    before = threading.active_count()
    with pytest.raises(ValueError, match="max_capacity"):
        count_batches_pipelined(_copies(batches), 8, capacity=16,
                                max_capacity=256, queue_depth=1,
                                device="cpu")
    for t in threading.enumerate():
        if isinstance(t, pipeline._Feeder):
            t.join(timeout=10)
            assert not t.is_alive()
    assert threading.active_count() <= before
