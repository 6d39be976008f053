"""Ascending sort of every row of a 2-D tensor: the wrapper of the
hand-written CUDA kernel (``csrc/row_sort.cu``), its plain PyTorch
version, and its launch count.

Replaces the Pallas probe kernel ``scripts/probe_pallas2.py`` ``k_sort``
(``jnp.sort(x, axis=1)`` on a ``[64, 128]`` tile), and sorts the rows of
the sample-partition count engine (``probes/partition.py``).  Two kinds
of rows:

* int64 keys sort in signed order, the order of the port's keys after
  ``key ^ SIGN_FLIP`` (``ops/count.py``); rows up to 16,384 keys;
* 32-bit words (int32, uint32 or float32) sort as unsigned 32-bit values,
  whatever the tensor's dtype, as the TPU probe's uint32 tile did; rows up
  to 32,768 words.

The width is a power of two up to that limit (one block's 128 KiB of
shared memory); any other width raises ``ValueError``, on every device.
The wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .build import KernelLibrary
from .words import WORD_DTYPES, from_u32, stream_of, to_u32

# the widest row, by bytes a key (kThreads * E in the CUDA source)
MAX_WIDTH = {8: 16384, 4: 32768}

_LIB = KernelLibrary("row_sort", {
    "row_sort_max_width": [ctypes.c_int],
    "row_sort_launch": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
})


def build():
    """Build (if needed) and load the kernel library."""
    return _LIB.load()


def _check(x: torch.Tensor) -> int:
    """Raises on what the kernel does not take; returns bytes a key."""
    if x.dtype == torch.int64:
        key_bytes = 8
    elif x.dtype in WORD_DTYPES:
        key_bytes = 4
    else:
        raise TypeError(f"row_sort needs int64 keys or 32-bit words, got "
                        f"{x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"row_sort needs a 2-D tensor, got {x.dim()}-D")
    if not x.is_contiguous():
        raise ValueError("row_sort needs a contiguous tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"row_sort runs on cpu or cuda, not {x.device}")
    width, limit = x.shape[1], MAX_WIDTH[key_bytes]
    if not (0 < width <= limit and width & (width - 1) == 0):
        raise ValueError(f"row_sort takes rows of a power-of-two width up to "
                         f"{limit} for {x.dtype}, got {width}")
    return key_bytes


def row_sort_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.sort(dim=1)`` of the int64 keys, or
    of int64 copies of the words' unsigned values."""
    if _check(x) == 8:
        return torch.sort(x, dim=1).values
    return from_u32(torch.sort(to_u32(x), dim=1).values, x.dtype)


def row_sort(x: torch.Tensor) -> torch.Tensor:
    """Every row of ``x`` sorted ascending: int64 as signed, 32-bit words
    as unsigned."""
    key_bytes = _check(x)
    if x.device.type == "cpu":
        return row_sort_reference(x)
    out = torch.empty_like(x)
    if x.numel():
        _LIB.launch("row_sort_launch", x.data_ptr(), out.data_ptr(),
                    x.shape[0], x.shape[1], key_bytes, stream_of(x))
        row_sort.launches += 1
    return out


row_sort.launches = 0  # kernel launches (CUDA calls only)
