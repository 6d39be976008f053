"""The port's segment counts vs kmer_tpu's Pallas kernel (interpret mode).

``segment_counts_reference`` (plain PyTorch, the CPU path of the port's
wrapper) must return the Pallas kernel's ``counts`` slot for slot and its
``n_unique``, on the cases of tests/test_pallas.py.  Integers, so every
comparison is exact.  The CUDA kernel itself is compared with the plain
version on the card (chip_smoke.py and tests/test_torch_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu.pallas.segment_counts import segment_counts_sorted
from kmer_tpu_torch.kernels.segment_counts import (
    segment_counts,
    segment_counts_reference,
)
from kmer_tpu_torch.packed import as_int64, key_from_hi_lo


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    u32 = np.uint32
    if name == "random_with_duplicates":
        return (rng.integers(0, 7, 5000).astype(u32),
                rng.integers(0, 5, 5000).astype(u32), None)
    if name == "segment_spanning_blocks":
        hi = np.zeros(4096, u32)
        hi[-1] = 9
        return hi, np.zeros(4096, u32), None
    if name == "block_aligned_n":
        return rng.integers(0, 3, 2048).astype(u32), np.zeros(2048, u32), None
    if name == "all_unique":
        return np.arange(1500, dtype=u32), np.arange(1500, dtype=u32), None
    if name == "sentinel_folding":
        hi = rng.integers(0, 5, 3000).astype(u32)
        lo = rng.integers(0, 3, 3000).astype(u32)
        hi[:700], lo[:700] = 0xFFFFFFFF, 0xFFFF0000
        return hi, lo, (0xFFFFFFFF, 0xFFFF0000)
    if name == "high_bit_keys":  # signed-vs-unsigned order must not matter
        hi = rng.choice(np.array([1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE], u32),
                        2500)
        return hi, rng.integers(0, 2, 2500).astype(u32), None
    if name == "tiny_1":
        return np.array([5], u32), np.array([0], u32), None
    if name == "tiny_2":
        return np.array([5, 5], u32), np.array([0, 1], u32), None
    raise KeyError(name)


CASES = ["random_with_duplicates", "segment_spanning_blocks",
         "block_aligned_n", "all_unique", "sentinel_folding",
         "high_bit_keys", "tiny_1", "tiny_2"]


def _sorted(hi, lo):
    order = np.lexsort((lo, hi))
    return hi[order], lo[order]


@pytest.mark.parametrize("name", CASES)
def test_reference_matches_pallas_slot_for_slot(name):
    hi, lo, sent = _case(name)
    shi, slo = _sorted(hi, lo)
    want, want_unique = segment_counts_sorted(
        jnp.asarray(shi), jnp.asarray(slo), sentinel=sent, interpret=True,
        block_rows=8)
    keys = torch.from_numpy(key_from_hi_lo(shi, slo).copy())
    sentinel = None if sent is None else as_int64((sent[0] << 32) | sent[1])
    got, got_unique = segment_counts_reference(keys, sentinel)
    assert got.dtype == torch.int32 and got_unique.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_unique) == int(want_unique)


@pytest.mark.parametrize("name", CASES)
def test_wrapper_on_cpu_is_the_reference(name):
    hi, lo, sent = _case(name)
    keys = torch.from_numpy(key_from_hi_lo(*_sorted(hi, lo)).copy())
    sentinel = None if sent is None else (sent[0] << 32) | sent[1]
    before = segment_counts.launches
    got, got_u = segment_counts(keys, sentinel)
    ref, ref_u = segment_counts_reference(keys, sentinel)
    assert torch.equal(got, ref) and int(got_u) == int(ref_u)
    assert segment_counts.launches == before  # no kernel ran on the CPU


def test_empty_input():
    counts, n_unique = segment_counts(torch.zeros(0, dtype=torch.int64))
    assert counts.shape == (0,) and int(n_unique) == 0


@pytest.mark.parametrize("bad, err", [
    (torch.zeros(8, dtype=torch.int32), TypeError),
    (torch.zeros((2, 4), dtype=torch.int64), ValueError),
    (torch.zeros(16, dtype=torch.int64)[::2], ValueError),
])
def test_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        segment_counts(bad)
