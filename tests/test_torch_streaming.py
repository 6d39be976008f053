"""The port's streaming counts (kmer_tpu_torch.streaming) and
ResumableCount against kmer_tpu's (JAX on the CPU), on the same seeded
numpy inputs.

Trimmed (hi, lo, length) and counts are compared exactly.  Checkpoints
written by one package are resumed by the other.  The case list follows
tests/test_streaming.py and the ResumableCount cases of
tests/test_api.py and tests/test_wide.py.
"""

import collections
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmer_tpu.streaming as js
from kmer_tpu.codec import decode_codes
from kmer_tpu.ops.count import count_kmers_jit
from kmer_tpu.ops.extract import extract_to_strings, simulate_reads
from kmer_tpu.utils.checkpoint import ResumableCount as JaxResumable
from kmer_tpu_torch import streaming
from kmer_tpu_torch.ops.count import count_column, count_kmers
from kmer_tpu_torch.packed import KmerColumn, PackedKmers
from kmer_tpu_torch.streaming import (
    count_long_sequence, count_read_stream, iter_chunks_with_overlap)
from kmer_tpu_torch.utils.checkpoint import ResumableCount
from kmer_tpu_torch.utils.logging import StatsCounters


def _trimmed(t):
    """(hi, lo, length, 64-bit counts) of a trimmed table of either
    package."""
    t = t.trim()
    if hasattr(t, "hi"):
        counts = (t.counts64() if hasattr(t, "counts64")
                  else np.asarray(t.counts, np.int64))
        return (np.asarray(t.hi), np.asarray(t.lo), np.asarray(t.length),
                counts)
    hi, lo, length = t.to_numpy()[:3]
    counts = t.counts64() if hasattr(t, "counts64") else \
        t.counts.numpy().astype(np.int64)
    return hi, lo, length, counts


def _assert_same(got, want):
    for name, g, w in zip(("hi", "lo", "length", "counts"), _trimmed(got),
                          _trimmed(want)):
        np.testing.assert_array_equal(g, w, err_msg=name)


def _oracle(codes, k):
    return dict(collections.Counter(extract_to_strings(decode_codes(codes),
                                                       k)))


# --- iter_chunks_with_overlap ------------------------------------------------


@pytest.mark.parametrize("n, chunk, k", [(1000, 128, 7), (1000, 1000, 7),
                                         (1000, 4096, 31), (3, 128, 5),
                                         (130, 32, 31), (64, 16, 1)])
def test_chunks_match_kmer_tpu(n, chunk, k):
    codes = np.random.default_rng(n).integers(0, 4, n, np.uint8)
    got = list(iter_chunks_with_overlap(codes, chunk, k))
    want = list(js.iter_chunks_with_overlap(codes, chunk, k))
    assert len(got) == len(want)
    for (gp, gn), (wp, wn) in zip(got, want):
        np.testing.assert_array_equal(gp, wp)
        assert gn == wn
    assert sum(p.size - k + 1 for p, _ in got) == max(n - k + 1, 0)


# --- count_long_sequence ------------------------------------------------------


@pytest.mark.parametrize("k", [1, 9, 31, 32])
@pytest.mark.parametrize("where", ["below", "at", "above"])
def test_long_sequence_matches_kmer_tpu(k, where):
    n = 2000
    chunk = {"below": 512, "at": n, "above": 4096}[where]
    codes = np.random.default_rng(k).integers(0, 4, n, np.uint8)
    codes[100:200] = 3  # all-t windows, bit 63 set
    stats = StatsCounters()
    got = count_long_sequence(codes, k, canonical=k % 2 == 1, chunk=chunk,
                              stats=stats, device="cpu")
    want = js.count_long_sequence(codes, k, canonical=k % 2 == 1,
                                  chunk=chunk)
    _assert_same(got, want)
    assert got.distinct() == int(want.n_unique)
    assert stats.kmers == n - k + 1


def test_long_sequence_rows_split_a_chunk(monkeypatch):
    """Rows narrower than the chunk: a chunk boundary and a row boundary
    each fall inside a window, and every window counts once."""
    k, chunk = 9, 256
    monkeypatch.setattr(streaming, "ROW_MAX", 64)
    codes = np.zeros(1000, np.uint8)
    step, row_step = chunk - (k - 1), 64 - (k - 1)
    # a marker 9-mer across the first row boundary and one across the
    # first chunk boundary
    for at in (row_step - 4, step - 4):
        codes[at: at + k] = [3, 1, 2, 3, 3, 2, 1, 3, 2]
    got = count_long_sequence(codes, k, chunk=chunk, device="cpu")
    assert got.to_dict() == _oracle(codes, k)
    assert got.to_dict()["tcgttgctg"] == 2
    want = js.count_long_sequence(codes, k, chunk=chunk)
    _assert_same(got, want)


def test_long_sequence_rows_at_full_width():
    """Chunks wider than ROW_MAX, at the real row width."""
    k = 31
    n = 3 * streaming.ROW_MAX + 777
    codes = np.random.default_rng(31).integers(0, 4, n, np.uint8)
    chunk = 2 * streaming.ROW_MAX + 16 * 100
    got = count_long_sequence(codes, k, canonical=True, chunk=chunk,
                              device="cpu")
    _assert_same(got, js.count_long_sequence(codes, k, canonical=True,
                                             chunk=chunk))


def test_long_sequence_errors():
    with pytest.raises(ValueError, match="shorter than k"):
        count_long_sequence(np.zeros(5, np.uint8), 9, device="cpu")
    with pytest.raises(ValueError, match="word-aligned"):
        count_long_sequence(np.zeros(100, np.uint8), 9, chunk=50,
                            device="cpu")


def _first_chunks(codes, chunk, k, n_chunks):
    """The prefix of ``codes`` whose chunks are the first ``n_chunks`` of
    the whole sequence's."""
    return codes[: n_chunks * (chunk - (k - 1)) + k - 1]


@pytest.mark.parametrize("first", ["port", "kmer_tpu"])
def test_resumable_long_sequence_across_packages(first, tmp_path):
    """A run checkpointed after half its chunks by one package and
    finished by the other equals the uninterrupted one."""
    k, chunk = 11, 256
    codes = np.random.default_rng(7).integers(0, 4, 3000, np.uint8)
    n_chunks = len(list(iter_chunks_with_overlap(codes, chunk, k)))
    head = _first_chunks(codes, chunk, k, n_chunks // 2)
    path = str(tmp_path / "ck.npz")
    if first == "port":
        rc = ResumableCount(path, device="cpu")
        count_long_sequence(head, k, chunk=chunk, resumable=rc, device="cpu")
        rc.checkpoint()
        rest = JaxResumable(path)
        assert rest.shards_done == n_chunks // 2
        got = js.count_long_sequence(codes, k, chunk=chunk, resumable=rest)
    else:
        rc = JaxResumable(path)
        js.count_long_sequence(head, k, chunk=chunk, resumable=rc)
        rc.checkpoint()
        rest = ResumableCount(path, device="cpu")
        assert rest.shards_done == n_chunks // 2
        got = count_long_sequence(codes, k, chunk=chunk, resumable=rest,
                                  device="cpu")
    _assert_same(got, count_long_sequence(codes, k, chunk=chunk,
                                          device="cpu"))
    assert got.to_dict() == _oracle(codes, k)


def test_resumable_long_sequence_shorter_than_k(tmp_path):
    rc = ResumableCount(str(tmp_path / "ck.npz"), device="cpu")
    with pytest.raises(ValueError, match="shorter than k"):
        count_long_sequence(np.zeros(5, np.uint8), 9, resumable=rc,
                            device="cpu")


# --- ResumableCount (the cases of tests/test_api.py and test_wide.py) ---------


def test_resumable_count(tmp_path):
    reads = simulate_reads(32, 20, seed=1)
    lengths = np.full(32, 20, np.int32)
    k = 6
    shards = [(torch.from_numpy(reads[i: i + 8]),
               torch.from_numpy(lengths[i: i + 8])) for i in range(0, 32, 8)]
    path = str(tmp_path / "resume.npz")

    rc = ResumableCount(path, device="cpu")
    for i, (r, ln) in enumerate(shards[:2]):
        assert rc.should_process(i)
        rc.update(i, count_kmers(r, ln, k))
    rc.checkpoint()

    rc2 = ResumableCount(path, device="cpu")
    assert not rc2.should_process(0) and not rc2.should_process(1)
    for i, (r, ln) in enumerate(shards):
        if rc2.should_process(i):
            rc2.update(i, count_kmers(r, ln, k))
    full = count_kmers_jit(jnp.asarray(reads), jnp.asarray(lengths), k, False)
    assert rc2.table.to_dict() == full.to_dict()
    _assert_same(rc2.table, full)


def test_resumable_count_past_2_31(tmp_path):
    col = KmerColumn.from_packed(
        PackedKmers.from_strings(["acgt", "acgt", "ca"]), "cpu")
    table = count_column(col)
    batch = dataclasses.replace(table, counts=table.counts * 400_000_000)
    path = str(tmp_path / "wide_resume.npz")
    rc = ResumableCount(path, device="cpu")
    for i in range(3):
        rc.update(i, batch)
    rc.checkpoint()
    rc2 = ResumableCount(path, device="cpu")
    assert rc2.should_process(3) and not rc2.should_process(2)
    for i in range(3, 6):
        rc2.update(i, batch)
    assert rc2.table.to_dict() == {"acgt": 6 * 800_000_000,
                                   "ca": 6 * 400_000_000}
    # kmer_tpu resumes the port's snapshot with the 64-bit counts intact
    rc2.checkpoint()
    assert JaxResumable(path).table.to_dict() == rc2.table.to_dict()


def test_resumable_count_empty(tmp_path):
    path = str(tmp_path / "none.npz")
    rc = ResumableCount(path, device="cpu")
    assert rc.table is None and rc.shards_done == 0
    rc.checkpoint()  # nothing to write
    assert not os.path.exists(path)


# --- count_read_stream --------------------------------------------------------


def _stream(seed, n_batches, n, width, ragged=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        codes = rng.integers(0, 4, (n, width), np.uint8)
        lengths = (rng.integers(0, width + 1, n) if ragged
                   else np.full(n, width)).astype(np.int32)
        codes[0] = 3
        out.append((codes, lengths))
    return out


@pytest.mark.parametrize("k, canonical", [(6, False), (9, True), (21, True),
                                          (32, False)])
def test_read_stream_matches_kmer_tpu(k, canonical):
    batches = _stream(k, 3, 16, 40)
    stats = StatsCounters()
    got = count_read_stream(iter(batches), k, canonical, stats=stats,
                            device="cpu")
    want = js.count_read_stream(iter(batches), k, canonical)
    _assert_same(got, want)
    assert got.distinct() == int(want.n_unique)
    assert stats.batches == 3 and stats.reads == 48


def test_read_stream_oracle():
    batches = _stream(5, 3, 16, 30, ragged=False)
    want = collections.Counter()
    for codes, _ in batches:
        for row in codes:
            want.update(extract_to_strings(decode_codes(row), 6))
    assert count_read_stream(iter(batches), 6, device="cpu").to_dict() == \
        dict(want)


@pytest.mark.parametrize("spill_dir", [False, True])
def test_read_stream_spills_match_kmer_tpu(spill_dir, tmp_path):
    batches = _stream(1, 6, 64, 40)
    kw = dict(capacity=1 << 10, max_capacity=1 << 11,
              spill_dir=str(tmp_path / "runs") if spill_dir else None)
    got = count_read_stream(iter(batches), 9, **kw, device="cpu")
    want = js.count_read_stream(iter(batches), 9, **kw)
    _assert_same(got, want)
    assert got.distinct() == int(want.n_unique) > 1 << 11
    if spill_dir:
        assert any(f.startswith("spill_")
                   for f in os.listdir(tmp_path / "runs"))


def test_read_stream_wide_rows_split(monkeypatch):
    """A batch wider than ROW_MAX splits its rows with k-1 overlap."""
    monkeypatch.setattr(streaming, "ROW_MAX", 32)
    batches = _stream(2, 2, 8, 100)
    got = count_read_stream(iter(batches), 7, True, device="cpu")
    _assert_same(got, js.count_read_stream(iter(batches), 7, True))


def test_read_stream_empty_raises():
    with pytest.raises(ValueError, match="empty read stream"):
        count_read_stream(iter([]), 9, device="cpu")
