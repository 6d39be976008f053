"""The port's segment counts vs kmer_tpu's Pallas kernel (interpret mode).

``segment_counts_reference`` (plain PyTorch, the CPU path of the port's
wrapper) must return the Pallas kernel's ``counts`` slot for slot and its
``n_unique``, on the cases of tests/test_pallas.py and on the edges of
the CUDA kernel's tiles.  A numpy model of that kernel's tiling (tiles
counted on their own, the head of a tile's first segment found by a
backward search) is held against the plain version on the same cases.
Integers, so every comparison is exact.  The CUDA kernel itself is
compared with the plain version on the card (chip_smoke.py and
tests/test_torch_gpu.py).
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
from kernel_edges import EDGES, LARGE, TILE, edge_runs

T = TILE
SENTINEL = (0xFFFFFFFF, 0xFFFF0000)


def _runs(lengths, sentinel_run=0):
    """Keys 0, 1, ... repeated ``lengths`` times, then a sentinel run."""
    hi = np.repeat(np.arange(len(lengths)), lengths).astype(np.uint32)
    lo = np.zeros(hi.size, np.uint32)
    if not sentinel_run:
        return hi, lo, None
    return (np.r_[hi, np.full(sentinel_run, SENTINEL[0], np.uint32)],
            np.r_[lo, np.full(sentinel_run, SENTINEL[1], np.uint32)],
            SENTINEL)


def _case(name):
    if name in EDGES + LARGE:  # the edges of the CUDA kernel's tiles
        return _runs(*edge_runs(name, T))
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
         "high_bit_keys", "tiny_1", "tiny_2", *EDGES]


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


# --- a numpy model of the CUDA kernel's tiling --------------------------

HALO, LANES = 32, 32  # kHalo and the warp width in the CUDA source


def _search_head(keys, s, key):
    """The head slot of the segment holding slot s (keys[s - 1] == key),
    as the kernel's warp finds it: the HALO keys before s, then galloping
    probes 2^l slots back, then a 32-way search of the last interval.
    Returns (head, device-memory probes)."""
    lanes = np.arange(LANES)
    q = s - 1 - lanes
    differs = (q < 0) | (keys[np.maximum(q, 0)] != key)
    if differs.any():
        return s - int(np.argmax(differs)), 0
    hi = s - HALO
    q = np.where(lanes < 31, hi - (1 << np.minimum(lanes, 30)), -1)
    g = (q < 0) | (keys[np.maximum(q, 0)] != key)
    lane = int(np.argmax(g))
    lo, probes = max(int(q[lane]), -1), LANES
    if lane > 0:
        hi -= 1 << (lane - 1)
    while hi - lo > 1:
        step = (hi - lo + 31) // 32
        q = lo + (lanes + 1) * step
        match = (q >= hi) | (keys[np.minimum(q, hi)] == key)
        f = int(np.argmax(match))
        lo, hi = lo + f * step, min(hi, lo + (f + 1) * step)
        probes += LANES
    return hi, probes


def tiled_model(keys, sentinel=None, lead=0, tile=T):
    """(counts, n_unique, searches, probes) as the kernel computes them:
    tile t holds slots [t * tile - lead, (t + 1) * tile - lead), counted
    with no carry from other tiles."""
    n = keys.size
    counts = np.zeros(n, np.int32)
    n_unique = searches = probes = 0
    for t in range(-(-(n + lead) // tile)):
        lo, hi = max(0, t * tile - lead), min(n, (t + 1) * tile - lead)
        k, i = keys[lo:hi], np.arange(lo, hi)
        head = np.r_[lo == 0 or keys[lo] != keys[lo - 1], k[1:] != k[:-1]]
        tail = np.r_[k[:-1] != k[1:], hi == n or keys[hi - 1] != keys[hi]]
        if sentinel is not None:
            tail &= k != sentinel
        n_unique += int(tail.sum())
        hp = np.maximum.accumulate(np.where(head, i, -1))
        need = tail & (hp < 0)
        if need.any():  # the tile's first segment, headed before the tile
            hp[need], used = _search_head(keys, lo, keys[lo])
            searches, probes = searches + 1, probes + used
        counts[lo:hi][tail] = (i - hp + 1)[tail]
    return counts, n_unique, searches, probes


@pytest.mark.parametrize("lead", [0, 1])
@pytest.mark.parametrize("name", CASES + LARGE)
def test_tiled_model_matches_reference(name, lead):
    """The kernel's tiling and backward search, modelled in numpy, equal
    the plain version; with the pointer 8 bytes past a 16-byte boundary
    (lead 1) the tiles shift by one slot."""
    hi, lo, sent = _case(name)
    keys = key_from_hi_lo(*_sorted(hi, lo)).copy()
    sentinel = None if sent is None else as_int64((sent[0] << 32) | sent[1])
    counts, n_unique, searches, probes = tiled_model(keys, sentinel, lead)
    ref, ref_u = segment_counts_reference(torch.from_numpy(keys), sentinel)
    np.testing.assert_array_equal(counts, ref.numpy())
    assert n_unique == int(ref_u)
    if name == "one_run_over_every_tile":
        assert searches == 1  # only the tile holding its tail searches
    if name == "long_runs":
        assert 0 < probes <= searches * LANES * 5  # 2^30 slots in 5 rounds


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
