"""The port's distcount driver (kmer_tpu_torch.parallel.driver, the CLI's
``distcount``) and its feed against kmer_tpu's.

Rank processes of either package run on the CPU: the port's with the
gloo backend, kmer_tpu's with one virtual device each, so rank r of both
owns the same hash range and their rank files are equal rank for rank.
The case list follows tests/test_distcount.py, plus the checkpoint
refusals the port adds and the repaired ``file_batch_feed`` edges.
"""

import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

import kmer_tpu.pipeline as jp
from kmer_tpu.parallel.driver import file_batches_fixed as jax_batches_fixed
from kmer_tpu.parallel.driver import run_distcount as jax_distcount
from kmer_tpu.parallel.driver import split_long_reads as jax_split
from kmer_tpu_torch import pipeline
from kmer_tpu_torch.parallel.driver import (
    file_batches_fixed, merge_rank_files, run_distcount, split_long_reads)
from kmer_tpu_torch.parallel.launch import free_port
from kmer_tpu_torch.parallel.streaming import load_wide

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = "acgt"
K = 5


def _windows(s, k):
    return [s[i: i + k] for i in range(max(len(s) - k + 1, 0))]


def _oracle(seqs, k=K):
    want = Counter()
    for s in seqs:
        want.update(_windows(s, k))
    return dict(want)


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">r{i}\n{s}\n")


def _rand_seqs(n, rng, lo=3, hi=300):
    return ["".join(rng.choice(list(BASES), int(rng.integers(lo, hi))))
            for _ in range(n)]


def _rows(t):
    """(hi, lo, length, counts) of either package's trimmed table."""
    t = t.trim()
    if hasattr(t, "hi"):
        return (np.asarray(t.hi), np.asarray(t.lo), np.asarray(t.length),
                t.counts64())
    hi, lo, length = t.to_numpy()[:3]
    return hi, lo, length, t.counts64()


def _assert_same(a, b):
    for name, x, y in zip(("hi", "lo", "length", "counts"), _rows(a),
                          _rows(b)):
        np.testing.assert_array_equal(x, y, err_msg=name)


# --- the feed --------------------------------------------------------------


@pytest.mark.parametrize("width,k", [(64, 5), (32, 21), (48, 32), (16, 1)])
def test_split_long_reads_byte_identical(width, k):
    rng = np.random.default_rng(width + k)
    seqs = _rand_seqs(60, rng, lo=0, hi=500)
    codes = np.concatenate([[BASES.index(c) for c in s] for s in seqs]
                           ).astype(np.uint8)
    offs = np.concatenate([[0], np.cumsum([len(s) for s in seqs])]
                          ).astype(np.int64)
    rows, lens = split_long_reads(codes, offs, width, k)
    jrows, jlens = jax_split(codes, offs, width, k)
    assert rows.dtype == jrows.dtype and lens.dtype == jlens.dtype
    assert rows.tobytes() == jrows.tobytes()
    assert lens.tobytes() == jlens.tobytes()
    got = Counter()
    for row, ln in zip(rows, lens):
        got.update(_windows("".join(BASES[b] for b in row[:ln]), k))
    assert got == Counter(_oracle(seqs, k))


def test_split_long_reads_edges():
    rows, lens = split_long_reads(np.asarray([0, 1, 2], np.uint8),
                                  np.asarray([0, 3], np.int64), 16, K)
    assert rows.shape == (1, 16) and lens.tolist() == [3]
    with pytest.raises(ValueError):
        split_long_reads(np.zeros(4, np.uint8), np.asarray([0, 4]), 4, K)


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_file_batches_fixed_byte_identical(tmp_path, fmt):
    rng = np.random.default_rng(5)
    seqs = _rand_seqs(300, rng, lo=1, hi=400)
    path = str(tmp_path / f"r.{fmt}")
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            if fmt == "fasta":
                f.write(f">r{i}\n{s}\n")
            else:
                f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    got = list(file_batches_fixed(path, fmt, K, 32, 128, chunk_bytes=4096))
    want = list(jax_batches_fixed(path, fmt, K, 32, 128, chunk_bytes=4096))
    assert len(got) == len(want) > 3
    for (r, ln), (jr, jl) in zip(got, want):
        assert r.tobytes() == jr.tobytes() and ln.tobytes() == jl.tobytes()


def test_file_batch_feed_without_records_matches_kmer_tpu(tmp_path):
    """A file with no record probes nothing: est_windows is None (not 0),
    the batch stays auto-sized, and the count takes the fold, as in
    kmer_tpu (kmer_tpu/pipeline.py:646-651)."""
    for text in ("", "\n\n"):
        path = str(tmp_path / "e.fasta")
        with open(path, "w") as f:
            f.write(text)
        got = pipeline.file_batch_feed(path, "fasta", 21, None, None)
        want = jp.file_batch_feed(path, "fasta", 21, None, None)
        assert got[1:] == want[1:] and got[3] is None
        assert list(got[0]) == [] == list(want[0])


def test_file_batch_feed_survives_unreadable_size(tmp_path, monkeypatch):
    """os.path.getsize raising (a pipe, a vanished path) leaves the
    estimate None and the count unchanged, in both guarded places
    (kmer_tpu/pipeline.py:648-651 and :908-914)."""
    rng = np.random.default_rng(6)
    seqs = _rand_seqs(40, rng)
    path = str(tmp_path / "r.fasta")
    _write_fasta(path, seqs)

    def boom(p):
        raise OSError("no size")

    monkeypatch.setattr(os.path, "getsize", boom)
    got = pipeline.file_batch_feed(path, "fasta", K, None, None)
    want = jp.file_batch_feed(path, "fasta", K, None, None)
    assert got[1:] == want[1:] and got[3] is None
    table = pipeline.count_file(path, "fasta", K, capacity=4096,
                                device="cpu")
    assert table.to_dict() == _oracle(seqs)


# --- one process -------------------------------------------------------------


def test_single_process_matches_kmer_tpu_and_oracle(tmp_path):
    import jax

    from kmer_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(1)
    seqs = _rand_seqs(300, rng)
    fa = str(tmp_path / "reads.fasta")
    _write_fasta(fa, seqs)
    local, overflow = run_distcount(fa, K, batch=64, width=128,
                                    acc_capacity=4096, device="cpu")
    want, jovf = jax_distcount(fa, K, batch=64, width=128, acc_capacity=4096,
                               mesh=make_mesh((1, 1), jax.devices()[:1]))
    assert overflow == jovf == 0
    assert local.to_dict() == _oracle(seqs)
    _assert_same(local, want)
    assert local.n_unique == int(want.n_unique)


def test_checkpoint_resume(tmp_path):
    rng = np.random.default_rng(2)
    # reads shorter than the width: the head file's batches are a prefix
    seqs = _rand_seqs(200, rng, lo=6, hi=100)
    fa = str(tmp_path / "reads.fasta")
    _write_fasta(fa, seqs)
    kw = dict(batch=32, width=128, acc_capacity=2048, device="cpu")
    full, _ = run_distcount(fa, K, ckpt=str(tmp_path / "ck_full"),
                            ckpt_every=1, **kw)
    head = str(tmp_path / "head.fasta")
    _write_fasta(head, seqs[:64])
    ck = str(tmp_path / "ck")
    run_distcount(head, K, ckpt=ck, ckpt_every=1, **kw)
    resumed, overflow = run_distcount(fa, K, ckpt=ck, ckpt_every=4, **kw)
    assert overflow == 0
    _assert_same(resumed, full)


def test_kmer_tpu_checkpoint_resumes_in_the_port(tmp_path):
    import jax

    from kmer_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(12)
    seqs = _rand_seqs(200, rng, lo=6, hi=100)
    fa, head = str(tmp_path / "reads.fasta"), str(tmp_path / "head.fasta")
    _write_fasta(fa, seqs)
    _write_fasta(head, seqs[:64])
    ck = str(tmp_path / "ck")
    jax_distcount(head, K, batch=32, width=128, acc_capacity=2048,
                  mesh=make_mesh((1, 1), jax.devices()[:1]), ckpt=ck,
                  ckpt_every=1)
    resumed, overflow = run_distcount(fa, K, batch=32, width=128,
                                      acc_capacity=2048, ckpt=ck,
                                      ckpt_every=4, device="cpu")
    assert overflow == 0 and resumed.to_dict() == _oracle(seqs)


def test_mesh_mismatch_rejected(tmp_path):
    """kmer_tpu's check: a checkpoint of another mesh is refused."""
    import jax

    from kmer_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(3)
    fa = str(tmp_path / "r.fasta")
    _write_fasta(fa, _rand_seqs(80, rng))
    ck = str(tmp_path / "ck")
    jax_distcount(fa, K, batch=32, width=128, acc_capacity=2048,
                  mesh=make_mesh((2, 1), jax.devices()[:2]), ckpt=ck,
                  ckpt_every=1)
    with pytest.raises(ValueError, match="mesh"):
        run_distcount(fa, K, batch=32, width=128, acc_capacity=2048,
                      ckpt=ck, ckpt_every=1, device="cpu")


@pytest.mark.parametrize("change,what", [
    ({"k": 6}, "k=5"), ({"canonical": True}, "canonical=False"),
    ({"batch": 64}, "batch=32"), ({"width": 256}, "width=128")])
def test_checkpoint_of_other_settings_refused(tmp_path, change, what):
    """The port refuses a checkpoint whose k, canonical, batch or width
    differ (kmer_tpu checks only the mesh and the process count, and
    would fold other windows or skip other reads)."""
    rng = np.random.default_rng(13)
    fa = str(tmp_path / "r.fasta")
    _write_fasta(fa, _rand_seqs(80, rng))
    kw = dict(k=K, canonical=False, batch=32, width=128)
    ck = str(tmp_path / "ck")
    run_distcount(fa, acc_capacity=2048, ckpt=ck, ckpt_every=1,
                  device="cpu", **kw)
    with pytest.raises(ValueError, match=what):
        run_distcount(fa, acc_capacity=2048, ckpt=ck, ckpt_every=1,
                      device="cpu", **{**kw, **change})


class TestSpill:
    K8 = 8

    def test_spill_exceeds_capacity_exact(self, tmp_path):
        rng = np.random.default_rng(7)
        seqs = _rand_seqs(400, rng, lo=40, hi=200)
        fa = str(tmp_path / "reads.fasta")
        _write_fasta(fa, seqs)
        local, overflow = run_distcount(
            fa, self.K8, batch=8, width=256, acc_capacity=4096,
            ckpt=str(tmp_path / "ck"), ckpt_every=1,
            spill_dir=str(tmp_path / "runs"), spill_threshold=0.4,
            device="cpu")
        assert overflow == 0
        assert any(f.startswith("run_") for f in os.listdir(tmp_path /
                                                            "runs"))
        assert local.to_dict() == _oracle(seqs, self.K8)

    def test_spill_resume_carries_runs(self, tmp_path):
        rng = np.random.default_rng(8)
        seqs = _rand_seqs(192, rng, lo=40, hi=150)
        fa, head = str(tmp_path / "reads.fasta"), str(tmp_path / "h.fasta")
        _write_fasta(fa, seqs)
        _write_fasta(head, seqs[:96])
        kw = dict(batch=8, width=256, acc_capacity=2048, ckpt_every=1,
                  spill_threshold=0.4, device="cpu")
        straight, ovf = run_distcount(
            fa, self.K8, ckpt=str(tmp_path / "cks"),
            spill_dir=str(tmp_path / "runs_s"), **kw)
        assert ovf == 0
        run_distcount(head, self.K8, ckpt=str(tmp_path / "ckr"),
                      spill_dir=str(tmp_path / "runs_r"), **kw)
        resumed, ovf2 = run_distcount(
            fa, self.K8, ckpt=str(tmp_path / "ckr"),
            spill_dir=str(tmp_path / "runs_r"), **kw)
        assert ovf2 == 0
        assert resumed.to_dict() == straight.to_dict() == \
            _oracle(seqs, self.K8)


# --- rank processes -----------------------------------------------------------


def _run_ranks(argvs, jax_ranks=False, timeout=120):
    """Start one process per argv (the port's CLI, or kmer_tpu's with one
    virtual device each) and wait for all; every one is killed on the way
    out.  Returns [(rc, stdout, stderr)]."""
    env = dict(os.environ)
    if jax_ranks:
        env.pop("JAX_PLATFORMS", None)
        env["KMER_TPU_FORCE_CPU"] = "1"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
        mod = "kmer_tpu"
    else:
        mod = "kmer_tpu_torch"
        env["OMP_NUM_THREADS"] = "1"  # small batches; no spare cores here
    procs = [subprocess.Popen([sys.executable, "-m", mod, "distcount", *a],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for a in argvs]
    try:
        results = []
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            results.append((p.returncode, out, err))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _rank_args(tmp_path, stem, pid, port, *extra, jax_ranks=False):
    a = ["--input", str(tmp_path / f"{stem}{pid}.fasta"), "-k", str(K),
         "--batch", "64", "--width", "128", "--acc-capacity", "4096",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(pid), *extra]
    return a if jax_ranks else a + ["--backend", "gloo", "--device", "cpu"]


def _ok(results):
    outs = []
    for rc, out, err in results:
        assert rc == 0, f"rank failed:\n{out}\n{err}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


def _two_shards(tmp_path, seed, n=150, **kw):
    rng = np.random.default_rng(seed)
    shards = [_rand_seqs(n, rng, **kw), _rand_seqs(n, rng, **kw)]
    for pid, s in enumerate(shards):
        _write_fasta(tmp_path / f"s{pid}.fasta", s)
    return shards


def test_two_ranks_equal_kmer_tpu_rank_for_rank(tmp_path):
    shards = _two_shards(tmp_path, 4)
    port = free_port()
    outs = _ok(_run_ranks([_rank_args(
        tmp_path, "s", pid, port, "--out", str(tmp_path / "p"))
        for pid in (0, 1)]))
    assert {o["rank"] for o in outs} == {0, 1}
    assert all(o["overflow"] == 0 for o in outs)
    port = free_port()
    jouts = _ok(_run_ranks([_rank_args(
        tmp_path, "s", pid, port, "--out", str(tmp_path / "j"),
        jax_ranks=True) for pid in (0, 1)], jax_ranks=True))
    assert all(0 < o.pop("detail")["merge_efficiency"] <= 1 for o in outs)
    assert sorted(outs, key=lambda o: o["rank"]) == \
        sorted(jouts, key=lambda o: o["rank"])
    files = {pkg: [str(tmp_path / f"{pkg}.rank{r}.npz") for r in (0, 1)]
             for pkg in "pj"}
    for r in (0, 1):
        got, gmeta = load_wide(files["p"][r])
        want, wmeta = load_wide(files["j"][r])
        _assert_same(got, want)
        assert got.n_unique == want.n_unique
        assert gmeta == wmeta
    want = _oracle(shards[0] + shards[1])
    assert merge_rank_files(files["p"]).to_dict() == want
    # rank files of both packages merge together, in either order
    assert merge_rank_files([files["p"][0], files["j"][1]]).to_dict() == want
    assert merge_rank_files([files["j"][0], files["p"][1]]).to_dict() == want


def test_two_rank_checkpoints_resume_across_packages(tmp_path):
    """kmer_tpu's rank checkpoints over the head of each shard resume in
    the port over the whole shards, and end equal to the oracle."""
    shards = _two_shards(tmp_path, 14, n=128, lo=6, hi=100)
    for pid, s in enumerate(shards):
        _write_fasta(tmp_path / f"h{pid}.fasta", s[:64])
    ck = str(tmp_path / "ck")
    port = free_port()
    _ok(_run_ranks([_rank_args(tmp_path, "h", pid, port, "--ckpt", ck,
                               "--ckpt-every", "1", jax_ranks=True)
                    for pid in (0, 1)], jax_ranks=True))
    port = free_port()
    _ok(_run_ranks([_rank_args(tmp_path, "s", pid, port, "--ckpt", ck,
                               "--ckpt-every", "1", "--out",
                               str(tmp_path / "p")) for pid in (0, 1)]))
    merged = merge_rank_files([str(tmp_path / f"p.rank{r}.npz")
                               for r in (0, 1)])
    assert merged.to_dict() == _oracle(shards[0] + shards[1])


class TestRankDesyncRecovery:
    """A kill inside the write window can leave ranks' checkpoints at
    different batches: resume rewinds the rank ahead to .prev, or every
    rank fails alike, never a desynchronized collective."""

    def _pair(self, tmp_path, ck):
        port = free_port()
        return _run_ranks([_rank_args(
            tmp_path, "s", pid, port, "--batch", "32", "--ckpt-every", "1",
            "--ckpt", ck, "--out", str(tmp_path / "result"))
            for pid in (0, 1)])

    def _merged(self, tmp_path):
        return merge_rank_files([str(tmp_path / f"result.rank{r}.npz")
                                 for r in (0, 1)]).to_dict()

    def test_desync_rewinds_via_prev_generation(self, tmp_path):
        import shutil

        _two_shards(tmp_path, 21, n=128)
        ck = str(tmp_path / "ck")
        _ok(self._pair(tmp_path, ck))
        want = self._merged(tmp_path)
        assert os.path.exists(ck + ".rank0.npz.prev")
        shutil.copyfile(ck + ".rank0.npz.prev", ck + ".rank0.npz")
        _ok(self._pair(tmp_path, ck))
        assert self._merged(tmp_path) == want

    def test_desync_without_prev_fails_uniformly(self, tmp_path):
        import shutil

        _two_shards(tmp_path, 22, n=128)
        ck = str(tmp_path / "ck")
        _ok(self._pair(tmp_path, ck))
        shutil.copyfile(ck + ".rank0.npz.prev", ck + ".rank0.npz")
        os.remove(ck + ".rank0.npz.prev")
        os.remove(ck + ".rank1.npz.prev")
        res = self._pair(tmp_path, ck)
        assert all(r[0] != 0 for r in res), res
        assert any("disagree" in r[1] + r[2] for r in res), res


def test_two_ranks_spill_collective(tmp_path):
    shards = _two_shards(tmp_path, 11, n=100, lo=60, hi=140)
    port = free_port()
    outs = _ok(_run_ranks([[
        "--input", str(tmp_path / f"s{pid}.fasta"), "-k", "8", "--batch",
        "2", "--width", "256", "--acc-capacity", "2048", "--coordinator",
        f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
        str(pid), "--ckpt", str(tmp_path / "ck"), "--ckpt-every", "1",
        "--spill-dir", str(tmp_path / f"runs{pid}"), "--spill-threshold",
        "0.3", "--out", str(tmp_path / "result"), "--backend", "gloo",
        "--device", "cpu"] for pid in (0, 1)]))
    assert all(o["overflow"] == 0 for o in outs)
    for pid in (0, 1):
        assert any(f.startswith("run_")
                   for f in os.listdir(tmp_path / f"runs{pid}")), pid
    merged = merge_rank_files([str(tmp_path / f"result.rank{r}.npz")
                               for r in (0, 1)])
    assert merged.to_dict() == _oracle(shards[0] + shards[1], 8)


def test_cli_exits_3_on_overflow(tmp_path, capsys):
    """As kmer_tpu's: an accumulator too small for the keys is reported,
    and the command exits 3."""
    from kmer_tpu_torch.cli import main

    rng = np.random.default_rng(9)
    fa = str(tmp_path / "r.fasta")
    _write_fasta(fa, _rand_seqs(40, rng, lo=50, hi=100))
    assert main(["distcount", "--input", fa, "-k", str(K), "--batch", "64",
                 "--width", "128", "--acc-capacity", "8", "--device",
                 "cpu"]) == 3
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["overflow"] > 0 and out["rank"] == 0


def test_group_init_needs_a_backend(tmp_path):
    fa = str(tmp_path / "r.fasta")
    _write_fasta(fa, ["acgtacgt"])
    with pytest.raises(ValueError, match="backend"):
        run_distcount(fa, K, coordinator="127.0.0.1:1", num_processes=2,
                      process_id=0, device="cpu")
