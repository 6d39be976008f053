"""The port's CUDA kernels vs their plain PyTorch versions, on a card.

Every test here carries the ``gpu`` marker and skips inside the test
where ``torch.cuda.is_available()`` is False.  The file imports no JAX,
so it runs on a machine with a card and no JAX:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py sets JAX up for the CPU suite).
Every comparison is exact: the results are integers or 32-bit words.
"""

import numpy as np
import pytest
import torch

from kmer_tpu_torch.kernels.row_sort import row_sort, row_sort_reference
from kmer_tpu_torch.kernels.segment_copy import (
    copy_plan, segment_copy, segment_copy_reference)
from kmer_tpu_torch.kernels.segment_counts import (
    segment_counts, segment_counts_reference)
from kmer_tpu_torch.kernels.tile_gather import (
    tile_gather, tile_gather_reference)
from kmer_tpu_torch.kernels.tile_stages import (
    tile_stages, tile_stages_reference)
from kmer_tpu_torch.packed import SIGN_FLIP

L = 128


def _u32(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    """numpy words -> torch (uint32 travels as int32 bits)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n, distinct, sentinel", [
    (1, 1, False), (2, 2, False), (5000, 7, False), (4096 * 5 + 7, 1, False),
    (3000, 15, True), (1 << 20, 1 << 18, True)])
def test_kernel_matches_reference_on_cuda(n, distinct, sentinel):
    """The segment-count kernel, slot for slot, on sorted keys with bit 63
    set on some and (optionally) the folded all-ones sentinel."""
    dev = _cuda()
    rng = np.random.default_rng(n)
    vals = rng.integers(-(1 << 62), 1 << 62, distinct) * 2
    keys = torch.from_numpy(rng.choice(vals, n)).to(dev)
    if sentinel:
        keys[: n // 4] = -1
    keys = torch.sort(keys ^ SIGN_FLIP).values
    sent = (-1 ^ SIGN_FLIP) if sentinel else None
    before = segment_counts.launches
    got, got_u = segment_counts(keys, sent)
    ref, ref_u = segment_counts_reference(keys, sent)
    assert segment_counts.launches == before + 1
    assert torch.equal(got, ref) and int(got_u) == int(ref_u)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("axis, rows", [(1, 8), (0, 8), (0, 512), (None, 8)])
def test_tile_gather_kernel_matches_plain_on_cuda(axis, rows):
    dev = _cuda()
    x = _t(_u32((8, L) if axis is None else (4 * rows, L), 1)).to(dev)
    bound = {1: L, 0: rows, None: 8 * L}[axis]
    idx = _t(np.random.default_rng(2).integers(
        0, bound, (4 * rows, L)).astype(np.int32)).to(dev)
    before = tile_gather.launches
    got = tile_gather(x, idx, axis, tile_rows=rows, steps=1 if axis is None
                      else 5, add=0 if axis is None else 1)
    assert tile_gather.launches == before + 1
    ref = tile_gather_reference(x, idx, axis, tile_rows=rows,
                                steps=1 if axis is None else 5,
                                add=0 if axis is None else 1)
    assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["take2", "min", "min_add1", "add1", "copy"])
@pytest.mark.parametrize("axis", [1, 0])
def test_tile_stages_kernel_matches_plain_on_cuda(op, axis):
    dev = _cuda()
    x = _t(_u32((4 * 64, L), 3)).to(dev)
    lo = _t(_u32((4 * 64, L), 4)).to(dev) if op == "take2" else None
    sched = torch.tensor([0, 1, -3, 64, 200], dtype=torch.int32, device=dev)
    got = tile_stages(x, sched, op, axis, lo=lo, tile_rows=64)
    ref = tile_stages_reference(x, sched, op, axis, lo=lo, tile_rows=64)
    if lo is None:
        got, ref = (got,), (ref,)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1, 128, 1024])
def test_row_sort_kernel_matches_plain_on_cuda(width):
    dev = _cuda()
    x = _t(_u32((37, width), 5)).to(dev)
    assert torch.equal(row_sort(x), row_sort_reference(x))


@pytest.mark.gpu
@pytest.mark.parametrize("serial", [False, True])
def test_segment_copy_kernel_matches_plain_on_cuda(serial):
    dev = _cuda()
    src = _t(_u32(5000, 6)).to(dev)
    rng = np.random.default_rng(7)
    for g, seg in ((1, 1), (64, 33), (300, 16)):
        in_off = rng.integers(0, 5000 - seg + 1, g)
        in_off[-1] = 5000 - seg
        plan = copy_plan(in_off, rng.permutation(g) * seg, seg, 5000,
                         g * seg, serial=serial, device=dev)
        assert torch.equal(segment_copy(src, plan),
                           segment_copy_reference(src, plan))
    plan = copy_plan([1, 2, 3], [0, 0, 0], 7, 5000, 7, device=dev)
    assert plan.serial
    assert torch.equal(segment_copy(src, plan), src[3:10])
