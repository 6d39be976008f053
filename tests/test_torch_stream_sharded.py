"""The port's sharded stream (kmer_tpu_torch.parallel.streaming) against
kmer_tpu's on the virtual CPU mesh: rank r's accumulator shard equals
device r's, with the same n_unique and overflow; checkpoints resume, in
either package; the case list follows tests/test_stream_sharded.py."""

import json
import os

import jax
import numpy as np
import pytest

import torch_dist_tasks as tasks
from kmer_tpu.parallel.mesh import make_mesh as jax_mesh
from kmer_tpu.parallel.streaming import ResumableStream as JaxResumable
from kmer_tpu.parallel.streaming import batches_of as jax_batches_of
from kmer_tpu.parallel.streaming import stream_sharded_count as jax_stream

K = 5
N_BATCHES, N_READS, READ_LEN = 6, 8, 64
CAP = 4096


@pytest.fixture(scope="module")
def worlds():
    w = tasks.Worlds()
    yield w
    w.close()


def jax_shard(acc, rank: int, n_parts: int):
    lanes = [np.asarray(x).reshape(n_parts, -1)[rank] for x in
             (acc.hi, acc.lo, acc.length, acc.counts_hi, acc.counts_lo)]
    counts = (lanes[3].astype(np.int64) << 32) | lanes[4].astype(np.int64)
    live = counts > 0
    return tuple(x[live] for x in lanes[:3]) + (counts[live],)


def jax_run(shape, k, canonical, seed, n_batches, acc_capacity, ckpt=None,
            stop_after=None, ckpt_every=4):
    codes, lengths = tasks.make_batch(seed, n_batches * N_READS, READ_LEN,
                                      all_t=False)
    mesh = jax_mesh(shape, jax.devices()[: shape[0] * shape[1]])
    batches = list(jax_batches_of(codes, lengths, N_READS))[:stop_after]
    return jax_stream(batches, k, mesh, canonical=canonical,
                      acc_capacity=acc_capacity,
                      resumable=JaxResumable(ckpt) if ckpt else None,
                      ckpt_every=ckpt_every)


def assert_same_shards(got, acc, overflow):
    n = len(got)
    for r, g in enumerate(got):
        for name, a, b in zip(("hi", "lo", "length", "counts"), g["rows"],
                              jax_shard(acc, r, n)):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r} {name}")
        assert g["n_unique"] == int(acc.n_unique)
        assert g["overflow"] == overflow


@pytest.mark.parametrize("shape,k,canonical", [
    ((1, 1), 21, True), ((2, 1), 5, False), ((4, 1), 21, True),
    ((2, 2), 5, False), ((2, 1), 32, False)])
def test_stream_matches_kmer_tpu(worlds, shape, k, canonical):
    got = worlds.run(shape, tasks.stream_task, shape, k, canonical, 0,
                     N_BATCHES, N_READS, READ_LEN, CAP)
    acc, overflow = jax_run(shape, k, canonical, 0, N_BATCHES, CAP)
    assert overflow == 0
    assert_same_shards(got, acc, overflow)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_packed_step_equals_raw_step(worlds, shape):
    """The packed wire (one wire_keys launch with halo words) and the raw
    codes give the same accumulator."""
    for (raw, ovf), (packed, povf) in worlds.run(
            shape, tasks.packed_step_task, shape, 21, True, 4, N_READS,
            READ_LEN, CAP):
        assert ovf == povf == 0
        for a, b in zip(raw, packed):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1)])
def test_resume_matches_full_run(worlds, tmp_path, shape):
    ck = str(tmp_path / "stream.npz")
    full = worlds.run(shape, tasks.stream_task, shape, K, False, 2, 12,
                      N_READS, READ_LEN, CAP)
    worlds.run(shape, tasks.stream_task, shape, K, False, 2, 12, N_READS,
               READ_LEN, CAP, ck, 4, 8)
    with np.load(ck) as z:
        assert json.loads(str(z["meta"]))["batches_done"] == 8
    resumed = worlds.run(shape, tasks.stream_task, shape, K, False, 2, 12,
                         N_READS, READ_LEN, CAP, ck, 4)
    for f, r in zip(full, resumed):
        for a, b in zip(f["rows"], r["rows"]):
            np.testing.assert_array_equal(a, b)
        assert f["n_unique"] == r["n_unique"] and r["overflow"] == 0


@pytest.mark.parametrize("shape", [(2, 1)])
def test_checkpoints_resume_across_packages(worlds, tmp_path, shape):
    """A kmer_tpu checkpoint after 8 batches resumes in the port, and the
    port's in kmer_tpu; both end equal to kmer_tpu's full run."""
    acc, overflow = jax_run(shape, K, True, 3, 12, CAP)
    ck_j = str(tmp_path / "from_jax.npz")
    jax_run(shape, K, True, 3, 12, CAP, ckpt=ck_j, stop_after=8)
    got = worlds.run(shape, tasks.stream_task, shape, K, True, 3, 12,
                     N_READS, READ_LEN, CAP, ck_j, 4)
    assert_same_shards(got, acc, overflow)

    ck_p = str(tmp_path / "from_port.npz")
    worlds.run(shape, tasks.stream_task, shape, K, True, 3, 12, N_READS,
               READ_LEN, CAP, ck_p, 4, 8)
    assert JaxResumable(ck_p).batches_done == 8
    back, ovf = jax_run(shape, K, True, 3, 12, CAP, ckpt=ck_p)
    assert ovf == 0
    assert back.to_dict() == acc.to_dict()


def test_resume_refusals(worlds, tmp_path):
    from kmer_tpu_torch.parallel.launch import WorldError

    ck = str(tmp_path / "s.npz")
    worlds.run((2, 1), tasks.stream_task, (2, 1), K, False, 5, 4, N_READS,
               READ_LEN, CAP, ck)
    with pytest.raises(ValueError, match="mesh"):
        tasks.stream_task((1, 1), K, False, 5, 4, N_READS, READ_LEN, CAP, ck)
    # the port also refuses other windows on the same mesh
    for args, what in (((6, False), "k=5"), ((K, True), "canonical")):
        with pytest.raises(WorldError, match=what):
            worlds.run((2, 1), tasks.stream_task, (2, 1), *args, 5, 4,
                       N_READS, READ_LEN, CAP, ck)


def test_accumulator_overflow_flagged(worlds):
    got = worlds.run((2, 1), tasks.stream_task, (2, 1), K, False, 4, 8,
                     N_READS, READ_LEN, 8)
    assert all(g["overflow"] > 0 for g in got)


def test_empty_stream_raises():
    from kmer_tpu_torch.parallel.mesh import make_mesh
    from kmer_tpu_torch.parallel.streaming import stream_sharded_count

    with pytest.raises(ValueError, match="empty"):
        stream_sharded_count(iter(()), K, make_mesh((1, 1), device="cpu"))


def test_batches_of_matches_kmer_tpu():
    from kmer_tpu_torch.parallel.streaming import batches_of

    codes, lengths = tasks.make_batch(6, 20, 24)
    got = list(batches_of(codes, lengths, 8))
    want = list(jax_batches_of(codes, lengths, 8))
    assert len(got) == len(want) == 3
    for (c, ln), (wc, wl) in zip(got, want):
        np.testing.assert_array_equal(c, wc)
        np.testing.assert_array_equal(ln, wl)
        assert ln.dtype == wl.dtype


def test_checkpoint_layout_is_v2(worlds, tmp_path):
    ck = str(tmp_path / "v2.npz")
    worlds.run((2, 1), tasks.stream_task, (2, 1), K, False, 7, 4, N_READS,
               READ_LEN, CAP, ck)
    assert os.path.exists(ck)
    with np.load(ck) as z:
        meta = json.loads(str(z["meta"]))
        assert meta["version"] == 2 and meta["mesh_shape"] == [2, 1]
        assert z["live_per_shard"].shape == (2,)
        assert int(z["shard_cap"]) == CAP
