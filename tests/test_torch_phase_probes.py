"""The phase probes of ``scripts/`` (``kmer_tpu_torch.probes``: feed,
device_phases, count_phases, read_stream, checkpoint) at their small
sizes on the CPU, each held against ``kmer_tpu`` (JAX on the CPU) on the
same seeded inputs.  Tables compare exactly, through ``rows_digest`` of
their live rows in key order.

The stream families (fold_step, stream_loop, distcount_step) are in
``test_torch_phase_probes_stream.py``; the matrix-unit rates in
``test_torch_matmul_probes.py``.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import kmer_tpu.native as jax_native
from kmer_tpu.cli import _reads_file_batches
from kmer_tpu.ops.count import count_kmers as jax_count_kmers
from kmer_tpu.parallel.streaming import load_wide as jax_load_wide
from kmer_tpu.pipeline import count_file as jax_count_file
from kmer_tpu.streaming import count_read_stream as jax_count_read_stream
from kmer_tpu_torch import native
from kmer_tpu_torch.probes import (
    FAMILIES, PHASE_KERNELS, checkpoint, count_phases, device_phases, feed,
    read_stream)
from kmer_tpu_torch.probes.common import (
    PhaseRecord, rows_digest, table_digest)
from phase_probe_helpers import jax_digest, one_thread  # noqa: F401

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(family, tmp_path_factory, name):
    work = tmp_path_factory.mktemp(name)
    return str(work), list(family.run(CPU, small=True, workdir=str(work)))


# --- feed --------------------------------------------------------------------


@pytest.fixture(scope="module")
def feed_run(tmp_path_factory):
    return _run(feed, tmp_path_factory, "feed")


def test_feed_probes_are_correct(feed_run):
    _, recs = feed_run
    assert [r.name for r in recs] == [
        "native parse+encode", "feed batch=4096", "feed batch=65536"]
    assert all(r.correct and r.family == "feed" for r in recs)
    assert recs[0].detail["parse_threads"] == native._parse_threads()


@pytest.mark.parametrize("batch", feed.BATCHES)
def test_feed_totals_match_kmer_tpu_reads_file_batches(feed_run, batch):
    work, recs = feed_run
    rec = next(r for r in recs if r.name == f"feed batch={batch}")
    reads = bases = 0
    for rows, lengths in _reads_file_batches(
            os.path.join(work, "feed.fastq"), "fastq", 21, batch=batch):
        reads += rows.shape[0]
        bases += int(np.asarray(lengths, np.int64).sum())
    assert (rec.detail["reads"], rec.detail["bases"]) == (reads, bases)
    assert (reads, bases) == (3300, 3300 * 150)


def test_feed_encoding_matches_kmer_tpu(feed_run):
    work, _ = feed_run
    with open(os.path.join(work, "feed.fastq"), "rb") as f:
        data = f.read()
    codes, offs = native.fastq_encode(data)
    want_codes, want_offs = jax_native.fastq_encode(data)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(offs, want_offs)


def test_feed_file_is_the_scripts_records(tmp_path):
    """The script's per-read loop (probe_feed.py), byte for byte, on a
    cut of its reads: two of its blocks of 100,000."""
    rng = np.random.default_rng(0)
    letters = np.frombuffer(b"ACGT", np.uint8)
    qual = b"I" * 150
    n, parts = 150_000, []
    for s in range(0, n, feed.BLOCK):
        m = min(feed.BLOCK, n - s)
        seqs = letters[rng.integers(0, 4, (m, 150))]
        parts += [b"@r%d\n%s\n+\n%s\n" % (s + i, seqs[i].tobytes(), qual)
                  for i in range(m)]
    path = tmp_path / "r.fastq"
    assert feed.write_reads(str(path), n) == sum(map(len, parts))
    assert path.read_bytes() == b"".join(parts)


# --- device phases -----------------------------------------------------------


@pytest.fixture(scope="module")
def phases_run():
    return list(device_phases.run(CPU, small=True))


def test_device_phases_are_correct(phases_run):
    names = [r.name for r in phases_run]
    assert names[:3] == ["P_extract", "P_sort", "P_segcounts"]
    assert all(r.correct for r in phases_run)
    assert "one int64 sort" in phases_run[1].detail["stands_for"]


def test_device_phases_distinct_matches_kmer_tpu(phases_run):
    from kmer_tpu_torch.ops.extract import simulate_reads

    n = 1 << 10
    reads = simulate_reads(n, 150, seed=0)
    table = jax_count_kmers(reads, np.full(n, 150, np.int32), 21, True)
    seg = next(r for r in phases_run if r.name == "P_segcounts")
    assert seg.detail["distinct"] == int(table.n_unique)
    assert phases_run[0].detail["windows"] == n * 130


# --- count_file's phases -----------------------------------------------------


@pytest.fixture(scope="module")
def count_run(tmp_path_factory):
    return _run(count_phases, tmp_path_factory, "count")


@pytest.fixture(scope="module")
def jax_file_digest(count_run):
    work, _ = count_run
    path = count_phases.ingest_fastq(work, True)
    return jax_digest(jax_count_file(path, "fastq", 21, canonical=True))


def _tables(recs):
    return [(r.name, k, t) for r in recs for k, t in (r.tables or {}).items()]


def test_count_phases_are_correct(count_run):
    _, recs = count_run
    assert all(r.correct for r in recs), [r.name for r in recs
                                          if not r.correct]
    assert len(_tables(recs)) == 4


@pytest.mark.parametrize("which", range(4))
def test_count_phases_tables_equal_kmer_tpu_count_file(count_run,
                                                       jax_file_digest,
                                                       which):
    """Each count_file's trimmed table, and the resident compute's, equal
    kmer_tpu's count_file on the same file, row for row."""
    _, recs = count_run
    name, key, digest = _tables(recs)[which]
    assert digest == jax_file_digest, (name, key)
    assert digest["total"] == count_phases.SMALL_READS * 130


# --- the read stream ---------------------------------------------------------


@pytest.fixture(scope="module")
def stream_run(tmp_path_factory):
    return _run(read_stream, tmp_path_factory, "stream")


@pytest.fixture(scope="module")
def jax_stream_digest(stream_run):
    path = count_phases.ingest_fastq(stream_run[0], True)
    return jax_digest(jax_count_read_stream(
        _reads_file_batches(path, "fastq", 21, batch=256,
                            chunk_bytes=64 << 10), 21, canonical=True,
        capacity=1 << 12))


@pytest.mark.parametrize("which", ["merge", "shipped_e2e", "fast_e2e"])
def test_read_stream_tables_equal_kmer_tpu(stream_run, jax_stream_digest,
                                           which):
    _, recs = stream_run
    assert all(r.correct for r in recs)
    rec = next(r for r in recs if r.name == which)
    assert rec.tables[which] == jax_stream_digest


def test_read_batches_keep_every_read(stream_run):
    work, _ = stream_run
    path = count_phases.ingest_fastq(work, True)
    got = list(read_stream.read_batches(path, 300, 64 << 10))
    assert [c.shape[0] for c, _ in got] == [300] * 3 + [124]
    lengths = np.concatenate([ln for _, ln in got])
    with open(path, "rb") as f:
        codes, offs = native.fastq_encode(f.read())
    np.testing.assert_array_equal(lengths, np.diff(offs))
    rows = np.concatenate([c for c, _ in got])
    np.testing.assert_array_equal(rows[5, :150], codes[offs[5]: offs[6]])


# --- one checkpoint write ----------------------------------------------------


@pytest.fixture(scope="module")
def ckpt_run(tmp_path_factory):
    return _run(checkpoint, tmp_path_factory, "ckpt")


@pytest.mark.parametrize("name", sorted(checkpoint.FILES))
def test_checkpoint_files_load_in_kmer_tpu(ckpt_run, name):
    work, recs = ckpt_run
    assert all(r.correct for r in recs)
    acc = checkpoint.accumulator(*checkpoint.SMALL, CPU)
    loaded, meta = jax_load_wide(os.path.join(work, checkpoint.FILES[name]))
    assert jax_digest(loaded) == table_digest(acc)
    assert meta["mesh_shape"] == [1, 1]


def test_checkpoint_compressed_is_smaller(ckpt_run):
    _, recs = ckpt_run
    size = {r.name: r.detail["bytes"] for r in recs if r.detail
            and "bytes" in r.detail and r.name in checkpoint.FILES}
    assert size["atomic_savez compressed"] < size["atomic_savez plain"]
    assert size["save_wide plain"] == size["atomic_savez plain"]


# --- the records and the command line ----------------------------------------


def test_phase_families_are_registered():
    assert set(PHASE_KERNELS) <= set(FAMILIES)
    assert {"matmul", "device_phases", "fold_step"} <= set(FAMILIES)
    for family in FAMILIES.values():  # run_all passes every one a workdir
        assert "workdir" in inspect.signature(family.run).parameters


def test_phase_record_line_names_the_card_or_device():
    rec = PhaseRecord("x", "feed", "scripts/probe_feed.py", "cpu", True,
                      {"a": 0.5, "b": [0.25, 0.125]}, {"n": 3},
                      {"t": {"groups": 2, "total": 5, "sha256": "0"}})
    line = rec.line()
    assert line.startswith("x: correct: True; a 0.5000 s, b [0.2500 s, "
                           "0.1250 s]; n 3; t: 2 groups, total 5; [cpu]")
    rec.card = "NVIDIA H100 80GB HBM3, 700.00 W"
    assert rec.line().endswith("[NVIDIA H100 80GB HBM3, 700.00 W]")
    assert json.loads(json.dumps(dataclasses.asdict(rec)))["seconds"][
        "b"] == [0.25, 0.125]


def test_rows_digest_tells_tables_apart():
    a = rows_digest([1, 2], [3, 4], [21, 21], [5, 6])
    assert a == rows_digest(np.array([1, 2], np.uint32), [3, 4], [21, 21],
                            np.array([5, 6]))
    assert a != rows_digest([1, 2], [3, 4], [21, 21], [5, 7])
    assert (a["groups"], a["total"]) == (2, 11)


def test_cli_runs_a_phase_family_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "kmer_tpu_torch.probes", "--only",
         "checkpoint", "--device", "cpu", "--small"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("correct: True") == 7
