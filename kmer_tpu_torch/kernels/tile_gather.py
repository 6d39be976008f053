"""Gathers inside 32-bit tiles: the wrapper of the hand-written CUDA kernel
(``csrc/tile_gather.cu``), its plain PyTorch version, and its launch count.

Replaces the Pallas probe gathers: ``scripts/probe_pallas.py``
``k_gather_lanes`` / ``k_gather_rows`` / ``k_gather_table``,
``scripts/probe_pallas2.py`` ``k_gl`` / ``k_gr``, ``scripts/probe_pallas3.py``
``kg``, ``kt`` and the amplified ``k_gather1`` / ``k_gather0``.

``tile_gather(x, idx, axis)`` on ``x`` and ``idx`` of shape
``[tiles * tile_rows, lanes]``:

* ``axis=1``: ``out[r, c] = h[r, idx[r, c]]``, ``take_along_axis`` along
  lanes;
* ``axis=0``: ``take_along_axis`` along rows inside each tile of
  ``tile_rows`` rows (default: the whole array is one tile), with
  ``idx`` in ``[0, tile_rows)``;
* ``axis=None``: the flat-table form, ``out = x.reshape(-1)[idx]`` for a
  table of at most ``GROUP`` words and ``idx`` of any shape.

With ``steps`` and ``add`` the tile form repeats ``h = take(h, idx) +
add`` (an integer add on the 32-bit word, mod 2^32).  On the card one
step and the table form gather straight from device memory, and more
steps compose on chip: ``h0[idx^steps] + steps * add``, ``idx^steps`` by
repeated squaring (``csrc/tile_gather.cu``).  The wrapper takes the plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .build import KernelLibrary
from .words import check_words, from_u32, stream_of, to_u32

GROUP = 4096  # longest line, largest table (kGroup in the CUDA source)

_LIB = KernelLibrary("tile_gather", {
    "tile_gather_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_void_p],
    "tile_gather_table_launch": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p],
})


def build():
    """Build (if needed) and load the kernel library."""
    return _LIB.load()


def _check(x, idx, axis, tile_rows, steps):
    if idx.dtype != torch.int32:
        raise TypeError(f"tile_gather needs int32 indices, got {idx.dtype}")
    if not idx.is_contiguous():
        raise ValueError("tile_gather needs contiguous indices")
    if idx.device != x.device:
        raise ValueError(f"indices on {idx.device}, words on {x.device}")
    if axis is None:
        check_words(x, "tile_gather", dim=None)
        if not 1 <= x.numel() <= GROUP:
            raise ValueError(f"a flat table holds 1 to {GROUP} words, got "
                             f"{x.numel()}")
        return
    check_words(x, "tile_gather")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0, 1 or None, got {axis}")
    if idx.shape != x.shape:
        raise ValueError(f"indices {tuple(idx.shape)} and words "
                         f"{tuple(x.shape)} differ in shape")
    n_rows, lanes = x.shape
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if axis == 1 and lanes > GROUP:
        raise ValueError(f"axis 1 takes rows of at most {GROUP} lanes")
    if axis == 0 and not (0 < tile_rows <= GROUP and n_rows % tile_rows == 0):
        raise ValueError(f"axis 0 needs tiles of 1 to {GROUP} rows that "
                         f"divide {n_rows} rows, got {tile_rows}")


def tile_gather_reference(x: torch.Tensor, idx: torch.Tensor,
                          axis: int | None, tile_rows: int | None = None,
                          steps: int = 1, add: int = 0) -> torch.Tensor:
    """Plain PyTorch version: ``torch.gather`` on int64 copies of the
    words, tile by tile."""
    tile_rows = tile_rows or (x.shape[0] if x.dim() else 1)
    _check(x, idx, axis, tile_rows, steps)
    if axis is None:
        return from_u32(to_u32(x).reshape(-1)[idx.to(torch.int64)], x.dtype)
    n_rows, lanes = x.shape
    rows = tile_rows if axis == 0 else n_rows
    v = to_u32(x).reshape(-1, rows, lanes)
    i = idx.to(torch.int64).reshape(-1, rows, lanes)
    for _ in range(steps):
        v = torch.gather(v, 1 + axis, i) + add
    return from_u32(v.reshape(n_rows, lanes), x.dtype)


def tile_gather(x: torch.Tensor, idx: torch.Tensor, axis: int | None,
                tile_rows: int | None = None, steps: int = 1,
                add: int = 0) -> torch.Tensor:
    """The gather of the module docstring, as words of ``x``'s dtype."""
    tile_rows = tile_rows or (x.shape[0] if x.dim() else 1)
    _check(x, idx, axis, tile_rows, steps)
    if x.device.type == "cpu":
        return tile_gather_reference(x, idx, axis, tile_rows, steps, add)
    if axis is None:
        out = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
        if idx.numel() == 0:
            return out
        _LIB.launch("tile_gather_table_launch", x.data_ptr(), x.numel(),
                    idx.data_ptr(), idx.numel(), out.data_ptr(),
                    stream_of(x))
    else:
        out = torch.empty_like(x)
        if x.numel() == 0:
            return out
        n_rows, lanes = x.shape
        _LIB.launch("tile_gather_launch", x.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), n_rows, tile_rows, lanes, axis, steps,
                    add & 0xFFFFFFFF, stream_of(x))
    tile_gather.launches += 1
    return out


tile_gather.launches = 0  # kernel launches (CUDA calls only)
