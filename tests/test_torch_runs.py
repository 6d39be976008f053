"""The port's long runs at a small size on the CPU, against ``kmer_tpu``.

``runs.sustained``: the straight, killed and resumed phases in their own
processes (bit-exact, the oracle equal, a resume from batch >= 2); the
straight table against ``kmer_tpu.parallel.streaming
.stream_sharded_count`` on the same numpy batches; a ``kmer_tpu``
checkpoint resumed by the port.  ``runs.ingest``: the writer byte for
byte ``scripts/probe_ingest_rss.write_fastq``; the small and ckpt phases
with their tables against ``kmer_tpu.pipeline.count_file``; the count
child's peak RSS under the budget.  ``scripts/sustained_r4.py``'s resume
phase is never run: it writes the repository's SUSTAINED.json.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kmer_tpu.parallel.mesh import make_mesh as jax_mesh
from kmer_tpu.parallel.streaming import ResumableStream as JaxResumable
from kmer_tpu.parallel.streaming import stream_sharded_count as jax_stream
from kmer_tpu.pipeline import count_file as jax_count_file
from kmer_tpu_torch.parallel.streaming import load_live
from kmer_tpu_torch.pipeline import count_file
from kmer_tpu_torch.runs import ingest, sustained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# small inputs; the other test files' workers share the cores
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")
CFG = sustained.Config(batch_reads=4096, genome=20_000, acc_cap=65536,
                       ckpt_every=2, steps=9, kill_after=5)


def _run(module: str, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=ONE_THREAD, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One torch thread here and in every child (``runs.ingest``'s
    children inherit the environment)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the sustained stream ----------------------------------------------------


@pytest.fixture(scope="module")
def straight_dir(tmp_path_factory):
    """The port's straight phase, run once in this process."""
    d = str(tmp_path_factory.mktemp("sustained"))
    out = sustained.run_phase("straight", CFG, d, "cpu")
    assert out["start_batch"] == 0 and out["steps_run_this_process"] == 9
    return d


def _jax_rows(acc):
    t = acc.trim()
    counts = (np.asarray(t.counts_hi, np.int64) << 32) + np.asarray(
        t.counts_lo, np.int64)
    return (np.asarray(t.hi), np.asarray(t.lo), np.asarray(t.length),
            counts)


def _port_rows(path):
    t, _ = load_live(path)
    hi, lo, length, _, _ = t.to_numpy()
    return hi, lo, length, t.counts64()


def _jax_batches(cfg, n):
    _, _, reads = sustained.sources(cfg)
    lengths = np.full(cfg.batch_reads, sustained.READ_LEN, np.int32)
    return [(reads[i % len(reads)], lengths) for i in range(n)]


def test_straight_table_matches_kmer_tpu_stream(straight_dir):
    mesh = jax_mesh((1, 1), jax.devices()[:1])
    acc, overflow = jax_stream(_jax_batches(CFG, CFG.steps), sustained.K,
                               mesh, canonical=True,
                               acc_capacity=CFG.acc_cap)
    assert overflow == 0
    for a, b in zip(_port_rows(os.path.join(straight_dir, "straight.npz")),
                    _jax_rows(acc)):
        np.testing.assert_array_equal(a, b)


def test_kmer_tpu_checkpoint_resumes_in_the_port(straight_dir, tmp_path):
    shutil.copy(os.path.join(straight_dir, "straight.npz"), tmp_path)
    ckpt = str(tmp_path / "sustained.ckpt.npz")
    mesh = jax_mesh((1, 1), jax.devices()[:1])
    jax_stream(_jax_batches(CFG, 4), sustained.K, mesh, canonical=True,
               acc_capacity=CFG.acc_cap, resumable=JaxResumable(ckpt),
               ckpt_every=CFG.ckpt_every)
    out = sustained.run_phase("resume", CFG, str(tmp_path), "cpu")
    assert out["start_batch"] == 4 and out["steps_run_this_process"] == 5
    assert out["resumed_equals_straight"] and out["oracle_equal"]


def test_oracle_counts_every_window():
    genome, starts, _ = sustained.sources(CFG)
    keys, counts = sustained.oracle(genome, starts, CFG)
    assert int(counts.sum()) == CFG.steps * CFG.windows_per_batch
    assert bool((keys[1:] > keys[:-1]).all())
    assert list(sustained.multiplicities(CFG)) == [2] + [1] * 7


def test_straight_kill_resume_in_processes(tmp_path):
    """``--phase all``: straight and resume in one process, the kill in
    a child of it that must exit 1."""
    record = str(tmp_path / "record.json")
    got = _run("kmer_tpu_torch.runs.sustained", "--phase", "all", "--dir",
               str(tmp_path), "--device", "cpu", "--record", record,
               *CFG.argv())
    assert got.returncode == 0, got.stderr
    with open(tmp_path / "kill.json") as f:
        kill = json.load(f)
    assert kill["killed_at_batch"] == CFG.kill_after
    resume = json.loads(got.stdout.strip().splitlines()[-1])
    assert resume["phase"] == "resume"
    assert resume["start_batch"] >= CFG.ckpt_every
    assert resume["steps_run_this_process"] == CFG.steps - resume[
        "start_batch"] > 0
    assert resume["resumed_equals_straight"] and resume["oracle_equal"]
    assert resume["distinct"] == resume["oracle_groups"]
    with open(record) as f:
        rec = json.load(f)
    assert rec["metric"] == "sustained_kmers_per_s_chip"
    assert rec["kill_resume_verified"] and rec["total_kmers"] == (
        CFG.steps * CFG.windows_per_batch)
    assert set(rec["phase_walls_s"]) == {"straight", "kill", "resume"}
    assert set(rec["phase_process_walls_s"]) == {"straight", "kill",
                                                 "resume"}
    assert {"card", "torch", "launches", "resume_stats"} <= set(rec)


def test_resume_without_a_landed_checkpoint_fails(straight_dir, tmp_path):
    shutil.copy(os.path.join(straight_dir, "straight.npz"), tmp_path)
    with pytest.raises(RuntimeError, match="no checkpoint landed"):
        sustained.run_phase("resume", CFG, str(tmp_path), "cpu")


# --- out-of-core ingest ------------------------------------------------------


def test_writer_is_byte_identical_to_the_reference(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "probe_ingest_rss", os.path.join(REPO, "scripts",
                                         "probe_ingest_rss.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    n = 250_000  # two of the writers' blocks
    a, b = str(tmp_path / "a.fastq"), str(tmp_path / "b.fastq")
    assert ingest.write_fastq(a, n, seed=8) == ref.write_fastq(b, n, seed=8)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert os.path.getsize(a) == ingest.fastq_size(n)
    assert ingest.n_reads_for(10.0) == 31_645_569
    assert ingest.fastq_size(31_645_569) == 9_957_243_125


def _same_as_kmer_tpu(rows, path):
    want = jax_count_file(path, "fastq", 21, canonical=True).trim()
    counts = (want.counts64() if hasattr(want, "counts64")
              else np.asarray(want.counts, np.int64))
    for a, b in zip(rows, (want.hi, want.lo, want.length, counts)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_ingest_phases_match_kmer_tpu(tmp_path, capsys):
    """The small phase here, the ckpt phase's children (the CLI straight,
    the killed and the resumed count) from here."""
    common = ["--dir", str(tmp_path), "--device", "cpu"]

    def phase(*argv):
        assert ingest.main([*argv, *common]) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    rec = phase("--phase", "small", "--small-reads", "3000")
    assert rec["failed_checks"] == []
    assert rec["small_byte_identical_chunked_vs_memory"]
    assert rec["small_rate_check"]["passed"]
    small_total = rec["small_total_kmers"]
    rec = phase("--phase", "ckpt", "--gb", "0.003792", "--batch", "2048",
                "--ckpt-every-s", "0")
    assert rec["failed_checks"] == [] and rec["big_reads"] == 12000
    ck = rec["big_ckpt_kill_resume"]
    assert 0 < ck["straight_peak_rss_bytes"] < 4000e6
    assert ck["kill_resume_bit_exact"] and ck["killed_while_running"]
    assert ck["resumed_from_batch"] >= 1 and ck["resume_batches_run"] >= 1
    assert ck["resumed_from_batch"] + ck["resume_batches_run"] == 6
    assert ck["total"] == 12000 * 130

    big = str(tmp_path / "big_12000.fastq")
    straight = ingest.load_table(str(tmp_path / "straight.ck.npz"))
    rows = ingest.load_table(str(tmp_path / "killed.ck.npz"))
    assert ingest.same_rows(rows, straight)
    _same_as_kmer_tpu(rows, big)
    small = str(tmp_path / "small_3000.fastq")
    rows = ingest.table_rows(count_file(small, "fastq", 21, canonical=True,
                                        chunk_bytes=64 << 20, device="cpu"))
    _same_as_kmer_tpu(rows, small)
    assert int(rows[3].sum()) == small_total == 3000 * 130


def test_ingest_record_needs_every_phase(tmp_path, capsys):
    """A record holds one run's phases, never a merge of several runs."""
    with pytest.raises(SystemExit) as e:
        ingest.main(["--phase", "small", "--dir", str(tmp_path),
                     "--device", "cpu", "--record",
                     str(tmp_path / "record.json")])
    assert e.value.code == 2
    assert "--record needs --phase all" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "record.json")


def test_big_phase_reads_the_childs_peak_rss(tmp_path):
    path = str(tmp_path / "big.fastq")
    ingest.write_fastq(path, 2000, seed=8)
    out, failed = ingest.big_phase(path, str(tmp_path), 4000, "cpu",
                                   full=False)
    assert failed == []
    assert 0 < out["big_child_peak_rss_bytes"] < 4000e6
    base = out["big_child_baseline_rss_bytes"]
    libs = out["big_child_baseline_library_rss_bytes"]
    assert 0 < libs < base <= out["big_child_peak_rss_bytes"]
    assert out["big_child_peak_rss_less_libraries_bytes"] == (
        out["big_child_peak_rss_bytes"] - libs)
    assert out["big_total_kmers"] == 2000 * 130
    assert len(out["big_top3"]) == 3
