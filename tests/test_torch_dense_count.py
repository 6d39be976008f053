"""The port's dense small-k count (kmer_tpu_torch.ops.dense_count) and
``count_kmers_auto`` against kmer_tpu's (JAX on the CPU), on the same
seeded numpy reads.

The dense table's raw arrays (all 4^k bins: hi, lo, length, counts) and
n_unique are compared exactly, and so are the trimmed tables of
``count_kmers_auto`` and the error class and string.  The one difference
by design: kmer_tpu's f32 histogram saturates at 2^24 a bin and rejects
such a table, the port's int64 histogram returns the exact count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmer_tpu.ops as jops
from kmer_tpu.ops.count import CountTable as JaxTable
from kmer_tpu.ops.dense_count import DENSE_EXACT_LIMIT as JAX_LIMIT
from kmer_tpu.ops.dense_count import check_dense_exact as jax_check
from kmer_tpu.ops.dense_count import count_kmers_dense as jax_dense
from kmer_tpu.ops.extract import simulate_reads
from kmer_tpu_torch.ops import DENSE_MAX_K, count_kmers_auto
from kmer_tpu_torch.ops.count import CountTable, count_kmers
from kmer_tpu_torch.ops.dense_count import (
    DENSE_EXACT_LIMIT, DENSE_ROUTE_K, check_dense_exact, count_kmers_dense,
    dense_histogram, right_aligned_keys)


def _reads(seed, n=24, width=40):
    reads = simulate_reads(n, width, seed=seed)
    lengths = np.random.default_rng(seed).integers(0, width + 1, n)
    lengths[0] = width
    lengths[1] = 0
    reads[2] = 3  # an all-t read: its keys have bit 63 set
    return reads, lengths.astype(np.int32)


def _jax_arrays(t):
    return (np.asarray(t.hi), np.asarray(t.lo), np.asarray(t.length),
            np.asarray(t.counts))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4, 6, 7, 8, 10])
def test_dense_raw_arrays_match_kmer_tpu(k, canonical):
    reads, lengths = _reads(k)
    want = jax_dense(jnp.asarray(reads), jnp.asarray(lengths), k, canonical)
    got = count_kmers_dense(torch.from_numpy(reads),
                            torch.from_numpy(lengths), k, canonical)
    assert got.capacity == 4 ** k
    for name, g, w in zip(("hi", "lo", "length", "counts"), got.to_numpy(),
                          _jax_arrays(want)):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.distinct() == int(want.n_unique)
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("k", [1, 6, 10])
def test_all_t_read_sets_the_sign_bit(k):
    reads = np.full((2, 30), 3, np.uint8)
    lengths = np.array([30, 12], np.int32)
    got = count_kmers_dense(torch.from_numpy(reads),
                            torch.from_numpy(lengths), k)
    assert got.to_dict() == {"t" * k: 30 - k + 1 + max(12 - k + 1, 0)}
    # the last bin (all t) is the only live one; its key has bit 63 set
    assert got.keys[-1].item() < 0 and got.counts[-1].item() > 0
    assert int((got.counts > 0).sum()) == 1
    np.testing.assert_array_equal(
        got.to_numpy()[3],
        _jax_arrays(jax_dense(jnp.asarray(reads), jnp.asarray(lengths), k,
                              False))[3])


def test_right_aligned_keys_mask_the_arithmetic_shift():
    keys = torch.tensor([-1, 0, 1 << 62, -(1 << 63)], dtype=torch.int64)
    assert right_aligned_keys(keys, 1).tolist() == [3, 0, 1, 2]
    assert right_aligned_keys(keys, 16).tolist() == [
        (1 << 32) - 1, 0, 1 << 30, 1 << 31]
    with pytest.raises(ValueError):
        right_aligned_keys(keys, 17)


def test_histogram_drops_invalid_slots():
    values = torch.tensor([0, 3, 3, 15, 15, 15])
    valid = torch.tensor([True, True, False, True, True, False])
    assert dense_histogram(values, valid, 2).tolist() == [
        1, 0, 0, 1] + [0] * 11 + [2]


@pytest.mark.parametrize("shape", [(37, 300), (5000,)])
@pytest.mark.parametrize("k", [1, 4, 7, 8])
def test_histogram_copies_sum_to_numpy_bincount(k, shape):
    """Small k spreads the adds over copies of the bins (every position
    along the last axis into one); their sum is the plain histogram."""
    rng = np.random.default_rng(k)
    values = rng.integers(0, 4 ** k, shape)
    valid = rng.random(shape) < 0.8
    got = dense_histogram(torch.from_numpy(values), torch.from_numpy(valid),
                          k)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), np.bincount(values[valid], minlength=4 ** k))


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [8, 11, 21])
def test_count_kmers_auto_matches_kmer_tpu(k, canonical):
    reads, lengths = _reads(100 + k)
    want = jops.count_kmers_auto(jnp.asarray(reads), jnp.asarray(lengths), k,
                                 canonical).trim()
    got = count_kmers_auto(torch.from_numpy(reads),
                           torch.from_numpy(lengths), k, canonical).trim()
    for name, g, w in zip(("hi", "lo", "length", "counts"), got.to_numpy(),
                          _jax_arrays(want)):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_k_above_dense_max_raises_the_same_error():
    reads = simulate_reads(4, 20, seed=0)
    lengths = np.full(4, 20, np.int32)
    with pytest.raises(ValueError) as want:
        jax_dense(jnp.asarray(reads), jnp.asarray(lengths), DENSE_MAX_K + 1,
                  False)
    with pytest.raises(ValueError) as got:
        count_kmers_dense(torch.from_numpy(reads), torch.from_numpy(lengths),
                          DENSE_MAX_K + 1)
    assert str(got.value) == str(want.value)
    assert DENSE_MAX_K == 10 and DENSE_ROUTE_K == 6


def _table(counts):
    counts = torch.tensor(counts, dtype=torch.int32)
    return CountTable(keys=torch.zeros(counts.numel(), dtype=torch.int64),
                      length=torch.full_like(counts, 4), counts=counts,
                      n_unique=int((counts > 0).sum()))


def test_lane_limit_guard():
    ok = _table([5, DENSE_EXACT_LIMIT - 1])
    assert check_dense_exact(ok) is ok
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        check_dense_exact(_table([5, DENSE_EXACT_LIMIT]))
    assert check_dense_exact(_table([])).capacity == 0


def test_2_24_a_bin_kmer_tpu_raises_the_port_counts_exactly():
    """The documented difference (ROADMAP §3): at 2^24 a bin kmer_tpu's
    f32 histogram may have saturated and it raises; the port's int64
    count is exact and equals the sort path's answer."""
    n = 1 << 24
    reads = np.zeros((1, n), np.uint8)
    lengths = np.array([n], np.int32)
    with pytest.raises(ValueError, match="2\\^24"):
        jops.count_kmers_auto(jnp.asarray(reads), jnp.asarray(lengths), 1)
    bad = JaxTable(hi=jnp.zeros(1, jnp.uint32), lo=jnp.zeros(1, jnp.uint32),
                   length=jnp.ones(1, jnp.int32),
                   counts=jnp.asarray([JAX_LIMIT], jnp.int32),
                   n_unique=jnp.asarray(1))
    with pytest.raises(ValueError):
        jax_check(bad)
    assert check_dense_exact(_table([JAX_LIMIT])).counts.tolist() == [
        JAX_LIMIT]
    codes, lens = torch.from_numpy(reads), torch.from_numpy(lengths)
    got = count_kmers_auto(codes, lens, 1)
    assert got.to_dict() == {"a": n}
    assert got.to_dict() == count_kmers(codes, lens, 1).to_dict()
