"""Ascending sort of every row of a uint32 tile: the wrapper of the
hand-written CUDA kernel (``csrc/row_sort.cu``), its plain PyTorch
version, and its launch count.

Replaces the Pallas probe kernel ``scripts/probe_pallas2.py`` ``k_sort``
(``jnp.sort(x, axis=1)`` on a ``[64, 128]`` tile).  Words sort as
unsigned 32-bit values, whatever the tensor's 32-bit dtype; the row
width is a power of two up to 1024.  The wrapper takes the plain version
only for a tensor on the CPU; for a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .build import KernelLibrary
from .words import check_words, from_u32, stream_of, to_u32

MAX_WIDTH = 1024  # kThreads in the CUDA source

_LIB = KernelLibrary("row_sort", {
    "row_sort_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_int, ctypes.c_void_p],
})


def build():
    """Build (if needed) and load the kernel library."""
    return _LIB.load()


def _check(x: torch.Tensor) -> None:
    check_words(x, "row_sort")
    width = x.shape[1]
    if not (0 < width <= MAX_WIDTH and width & (width - 1) == 0):
        raise ValueError(f"row_sort takes rows of a power-of-two width up to "
                         f"{MAX_WIDTH}, got {width}")


def row_sort_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.sort(dim=1)`` of int64 copies."""
    _check(x)
    return from_u32(torch.sort(to_u32(x), dim=1).values, x.dtype)


def row_sort(x: torch.Tensor) -> torch.Tensor:
    """Every row of ``x`` sorted ascending as unsigned words."""
    _check(x)
    if x.device.type == "cpu":
        return row_sort_reference(x)
    out = torch.empty_like(x)
    if x.numel():
        _LIB.launch("row_sort_launch", x.data_ptr(), out.data_ptr(),
                    x.shape[0], x.shape[1], stream_of(x))
        row_sort.launches += 1
    return out


row_sort.launches = 0  # kernel launches (CUDA calls only)
