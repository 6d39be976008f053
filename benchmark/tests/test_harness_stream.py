"""The ``codes`` mix: ``stream_sharded_count`` on a (1, 1) mesh over the
generator's code batches; with ``resumable``, checkpointed into a job
directory that is emptied before every job, so that no job resumes from
the finished checkpoint of the one before it and folds nothing."""

import os

import numpy as np
import pytest

from benchmark import harness
from benchmark.harness import make_job, table_of, with_job_dir
from benchmark.spec import Spec

import tiny

CONFIG = "scer-wgs-k21"
# the cell's stream, checkpointed every 4 of its 8 batches into the job
# directory, as distcount checkpoints
CKPT = {"resumable": "{job_dir}/stream.npz"}


def _cell(tmp_path, extra=CKPT):
    spec = Spec()
    cfg = {**spec.config({"config": CONFIG}), **tiny.sizes(CONFIG)}
    mx = {**Spec().mix({"traffic": "stream"}),
          **tiny.mix("scer-wgs-k21.stream"), **extra}
    mx["options"] = {**mx["options"], "ckpt_every": 4}
    gen = spec.module("gen", cfg["generator"])
    ref = spec.module("reference", cfg["reference"])
    data = gen.sample(cfg, 2 ** 33 + 5)
    job, made = make_job(mx, gen, data, cfg, str(tmp_path), "cpu")
    return job, mx, gen, data, ref.table(data), cfg


def _same(lanes, want):
    keys, length, counts = table_of(lanes)
    return (np.array_equal(keys, want[0]) and np.array_equal(counts, want[1])
            and bool((length == 21).all()))


def test_code_batches_hold_every_read():
    spec = Spec()
    cfg = {**spec.config({"config": CONFIG}), **tiny.sizes(CONFIG)}
    from benchmark.gen import wgs_reads

    r = wgs_reads.sample(cfg, 3)
    batches = wgs_reads.code_batches(r, 64)
    assert len(batches) == -(-r.n_reads // 64)
    assert {(c.shape, c.dtype, ln.shape, ln.dtype) for c, ln in batches} == {
        ((64, 150), np.dtype(np.uint8), (64,), np.dtype(np.int32))}
    codes = np.concatenate([c for c, _ in batches])
    lens = np.concatenate([ln for _, ln in batches])
    assert np.array_equal(codes[: r.n_reads], r.read_codes(0, r.n_reads))
    assert (lens[: r.n_reads] == 150).all() and not lens[r.n_reads:].any()
    assert not codes[r.n_reads:].any()


def test_every_job_folds_every_batch_and_checkpoints_twice(tmp_path):
    from kmer_tpu_torch.utils.logging import StatsCounters

    job, mx, _, _, want, _ = _cell(tmp_path)
    n = -(-tiny.sizes(CONFIG)["n_reads"] // mx["batch"])
    assert n == 8 and mx["options"]["ckpt_every"] == 4
    for _ in range(2):
        stats = StatsCounters()
        table, counters = job(stats)
        assert stats.batches == n
        assert counters["n_checkpoints"] == 2
        assert counters["ckpt_wait_s"] >= 0
        assert counters["codes_shape"] == [mx["batch"], 150]
        assert _same(table.trim().to_numpy(), want)
        assert os.listdir(tmp_path / "job") == ["stream.npz"]


def test_a_checkpoint_left_by_the_last_job_is_removed(tmp_path, monkeypatch):
    from kmer_tpu_torch.parallel import streaming
    from kmer_tpu_torch.parallel.mesh import make_mesh
    from kmer_tpu_torch.utils.logging import StatsCounters

    job, mx, gen, data, want, cfg = _cell(tmp_path)
    job(StatsCounters())
    left = tmp_path / "job" / "stream.npz"
    assert left.exists()
    # what the emptying prevents: a stream opened on the finished
    # checkpoint resumes past its last batch, folds nothing, and still
    # returns the right table
    stats = StatsCounters()
    acc, overflow = streaming.stream_sharded_count(
        gen.code_batches(data, mx["batch"]), cfg["k"],
        make_mesh((1, 1), device="cpu"), canonical=True,
        resumable=streaming.ResumableStream(str(left)), stats=stats,
        **mx["options"])
    assert stats.batches == 0 and overflow == 0
    assert _same(acc.trim().to_numpy(), want)
    # the harness's job with the emptying taken out skips its batches, and
    # the job fails for it
    monkeypatch.setattr(harness, "fresh_dir",
                        lambda path: os.makedirs(path, exist_ok=True))
    with pytest.raises(RuntimeError, match="folded 0 of 8 batches"):
        job(StatsCounters())


def test_without_resumable_no_job_dir_and_no_checkpoint(tmp_path):
    from kmer_tpu_torch.utils.logging import StatsCounters

    job, _, _, _, want, _ = _cell(tmp_path, extra={})
    table, counters = job(StatsCounters())
    assert counters == {"codes_shape": [64, 150]}
    assert _same(table.trim().to_numpy(), want)
    assert not (tmp_path / "job").exists()


def test_job_dir_fills_strings_only():
    got = with_job_dir({"a": "{job_dir}", "b": {"c": "{job_dir}/x.npz"},
                        "d": None, "e": 2.0}, "/w/job")
    assert got == {"a": "/w/job", "b": {"c": "/w/job/x.npz"}, "d": None,
                   "e": 2.0}
