"""Segment counts over a sorted int64 key stream: the wrapper of the
hand-written CUDA kernel (``csrc/segment_counts.cu``), its plain PyTorch
version, and its launch count.

Replaces the Pallas kernel ``kmer_tpu/pallas/segment_counts.py``
(``_kernel`` via ``segment_counts_sorted``).  Given keys in which equal
keys are adjacent, both versions return

* ``counts`` int32 ``[n]``: each equal-key segment's size at the
  segment's tail slot, 0 elsewhere, and 0 for slots equal to
  ``sentinel``;
* ``n_unique``: a 0-dim int32 tensor, the number of non-sentinel
  segments,

slot for slot what the Pallas kernel returns for the same keys split into
(hi, lo) lanes.

``segment_counts`` takes the plain version only for a tensor on the CPU.
For a CUDA tensor it launches the kernel (one launch a call) or raises.
Any contiguous view works, including one 8 bytes past a 16-byte boundary
such as ``buf[1:]``: the kernel loads a key left over at either end of
the array on its own.  The kernel is bound by memory (see the note in the
CUDA source); it works in tiles of ``segment_counts_tile()`` keys.
"""

from __future__ import annotations

import ctypes

import torch

from ..packed import as_int64
from .build import KernelLibrary
from .words import stream_of

_LIB = KernelLibrary("segment_counts", {
    "segment_counts_tile": [],
    "segment_counts_launch": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
})


def build() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    return _LIB.load()


def segment_counts_tile() -> int:
    """The built kernel's tile, in keys (builds the library)."""
    return build().segment_counts_tile()


def _check(keys: torch.Tensor) -> None:
    if keys.dtype != torch.int64:
        raise TypeError(f"segment_counts needs int64 keys, got {keys.dtype}")
    if keys.dim() != 1:
        raise ValueError(f"segment_counts needs 1-D keys, got {keys.dim()}-D")
    if not keys.is_contiguous():
        raise ValueError("segment_counts needs contiguous keys")
    if keys.numel() >= 1 << 31:
        raise ValueError(
            f"segment_counts supports < 2^31 keys, got {keys.numel()}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"segment_counts runs on cpu or cuda, not "
                         f"{keys.device}")


def segment_counts_reference(keys: torch.Tensor, sentinel: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: heads from neighbour compares, the running
    head position by ``cummax``, counts at live tails."""
    _check(keys)
    n = keys.numel()
    head = torch.ones(n, dtype=torch.bool, device=keys.device)
    head[1:] = keys[1:] != keys[:-1]
    tail = torch.ones_like(head)
    tail[:-1] = head[1:]
    pos = torch.arange(n, dtype=torch.int32, device=keys.device)
    head_pos = torch.cummax(torch.where(head, pos, -1), 0).values
    live = torch.ones_like(head) if sentinel is None else (
        keys != as_int64(sentinel))
    counts = torch.where(tail & live, pos - head_pos + 1, 0).to(torch.int32)
    return counts, (head & live).sum().to(torch.int32)


def segment_counts(keys: torch.Tensor, sentinel: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Counts at segment tails and the live-segment total (see module)."""
    _check(keys)
    if keys.device.type == "cpu":
        return segment_counts_reference(keys, sentinel)
    n = keys.numel()
    counts = torch.empty(n, dtype=torch.int32, device=keys.device)
    n_unique = torch.zeros((), dtype=torch.int32, device=keys.device)
    if n == 0:
        return counts, n_unique
    _LIB.launch("segment_counts_launch", keys.data_ptr(), n,
                int(sentinel is not None),
                0 if sentinel is None else as_int64(sentinel),
                counts.data_ptr(), n_unique.data_ptr(), stream_of(keys))
    segment_counts.launches += 1
    return counts, n_unique


segment_counts.launches = 0  # kernel launches (CUDA calls only)
