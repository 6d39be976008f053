"""The port's count_windows vs kmer_tpu's: trimmed tables (hi, lo, length,
counts) equal array for array, and n_unique equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu.ops import count as jc
from kmer_tpu.ops import extract as jx
from kmer_tpu_torch.ops import count as tc
from kmer_tpu_torch.ops import extract as tx
from kmer_tpu_torch.packed import hi_lo_from_key, key_from_hi_lo


def _jax_table(hi, lo, valid, k):
    t = jc.count_windows(jnp.asarray(hi), jnp.asarray(lo),
                         None if valid is None else jnp.asarray(valid), k)
    tt = t.trim()
    return (np.asarray(tt.hi), np.asarray(tt.lo), np.asarray(tt.length),
            np.asarray(tt.counts)), int(t.n_unique)


def _assert_same(hi, lo, valid, k):
    want, want_unique = _jax_table(hi, lo, valid, k)
    keys = torch.from_numpy(key_from_hi_lo(hi, lo).copy())
    table = tc.count_windows(
        keys, None if valid is None else torch.from_numpy(valid), k)
    got = table.trim().to_numpy()
    for name, g, w in zip(("hi", "lo", "length", "counts"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert table.distinct() == want_unique
    assert table.total() == int(want[3].astype(np.int64).sum())
    return table


def _windows(codes, lengths, k, canonical):
    keys, valid = tx.extract_windows_batch(torch.from_numpy(codes),
                                           torch.from_numpy(lengths), k)
    if canonical:
        keys = tx.canonicalize(keys, k)
    hi, lo = hi_lo_from_key(keys.numpy())
    return hi, lo, valid.numpy()


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("k, canonical", [
    (5, False), (15, True), (16, False), (21, True), (24, True), (31, True),
    (32, False), (32, True)])
def test_uniform_reads(k, canonical, masked):
    codes = jx.simulate_reads(64, 60, seed=k)
    lengths = np.random.default_rng(k).integers(0, 61, 64).astype(np.int32)
    hi, lo, valid = _windows(codes, lengths, k, canonical)
    _assert_same(hi, lo, valid if masked else None, k)


@pytest.mark.parametrize("k", [15, 21, 31])
def test_coverage_reads(k):
    codes = jx.simulate_coverage_reads(300, 50, 400, seed=k)
    lengths = np.full(300, 50, np.int32)
    hi, lo, valid = _windows(codes, lengths, k, canonical=True)
    table = _assert_same(hi, lo, valid, k)
    assert int(table.trim().counts.max()) > 10  # long equal-key segments


@pytest.mark.parametrize("k", [16, 21, 31, 32])
def test_all_t_keys(k):
    codes = np.full((8, 40), 3, np.uint8)
    lengths = np.array([40, 40, 39, 10, k, k - 1, 0, 40], np.int32)
    hi, lo, valid = _windows(codes, lengths, k, canonical=False)
    table = _assert_same(hi, lo, valid, k)
    want = sum(max(n - k + 1, 0) for n in lengths)
    assert table.to_dict() == {"t" * k: want}


def test_masked_k32_all_t_never_merges_with_sentinel():
    rng = np.random.default_rng(32)
    codes = rng.integers(0, 4, size=(20, 50)).astype(np.uint8)
    codes[::4] = 3
    lengths = rng.integers(0, 51, 20).astype(np.int32)
    lengths[0] = 50
    hi, lo, valid = _windows(codes, lengths, 32, canonical=False)
    assert ((hi == 0xFFFFFFFF) & (lo == 0xFFFFFFFF) & valid).any()
    assert (~valid).any()
    table = _assert_same(hi, lo, valid, 32)
    want = sum(max(int(n) - 31, 0) for n in lengths[::4])
    assert table.to_dict()["t" * 32] == want


@pytest.mark.parametrize("k", [21, 32])
def test_empty_valid_mask(k):
    rng = np.random.default_rng(k)
    hi = rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)
    lo = np.zeros(500, np.uint32)
    table = _assert_same(hi, lo, np.zeros(500, bool), k)
    assert table.distinct() == 0 and table.to_dict() == {}


def test_sorted_run_layout():
    keys = torch.tensor([7 << 40, -1, 3 << 40, 7 << 40], dtype=torch.int64)
    table = tc.count_windows(keys, torch.tensor([True, False, True, True]),
                             12)
    # unsigned order: the sentinel (all ones) sorts last and counts 0
    assert table.keys.tolist() == [3 << 40, 7 << 40, 7 << 40, -1]
    assert table.counts.tolist() == [1, 0, 2, 0]
    assert table.length.tolist() == [12, 12, 12, int(tc.SENTINEL_LEN)]
    assert table.capacity == 4 and table.distinct() == 2
