"""Roll-and-combine stage loops on 32-bit tiles: the wrapper of the
hand-written CUDA kernel (``csrc/tile_stages.cu``), its plain PyTorch
version, and its launch count.

Replaces the Pallas probe stage loops: ``scripts/probe_pallas.py``
``k_dynroll`` and ``k_vpu``; ``scripts/probe_pallas2.py`` ``k_dr``,
``k_roll_lanes``, ``k_ptpu_roll_lanes``, ``k_roll_rows``, ``k_concat_rows``
and ``k_roll_rows1``; ``scripts/probe_pallas3.py`` ``k0``, ``k_cmpex1``,
``k_cmpex1r`` and ``k_add``; ``scripts/probe_r2.py`` ``k_cmpex`` and
``k_cmpex0``.

``tile_stages(h, shifts, op, axis)`` on ``h`` (and ``lo`` for ``take2``)
of shape ``[tiles * tile_rows, lanes]`` runs one stage per entry of
``shifts`` (an int32 tensor on ``h``'s device).  Stage s takes
``partner = roll(x, shifts[s], axis)`` with ``np.roll``'s direction (a
positive shift moves words to higher indices; ``concat([h[d:], h[:d]])``
is a shift of -d), along lanes, or along rows inside each tile of
``tile_rows`` rows (default: one tile), then applies ``op``:

* ``take2``: (h, lo) becomes the lexicographic min, unsigned, of itself
  and its partner (returns both lanes);
* ``min``: ``min(partner, h)``, unsigned;
* ``min_add1``: ``min(partner, h) + 1``, mod 2^32;
* ``add1``: ``h + 1``, mod 2^32 (no partner; the shifts only count the
  stages);
* ``copy``: the partner itself (a roll by a shift held on the device).

On the card, ``add1`` and ``copy`` compose into one pass (an add of the
stage count; one roll by the schedule's sum, taken on the device), and
the dependent ops keep each row (axis 1) or tile column (axis 0) on chip
for every stage, one warp a line of up to 1,024 words and one block a
longer one (``csrc/tile_stages.cu``).  The wrapper takes the plain version
only for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from .build import KernelLibrary
from .words import MASK32, check_words, from_u32, stream_of, to_u32

GROUP = 4096  # the longest line the kernel holds on chip (kMaxLine)
OPS = {"take2": 0, "min": 1, "min_add1": 2, "add1": 3, "copy": 4}

_LIB = KernelLibrary("tile_stages", {
    "tile_stages_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
})


def build():
    """Build (if needed) and load the kernel library."""
    return _LIB.load()


def _check(h, shifts, op, axis, lo, tile_rows):
    check_words(h, "tile_stages")
    if op not in OPS:
        raise ValueError(f"op must be one of {sorted(OPS)}, got {op!r}")
    if (op == "take2") != (lo is not None):
        raise ValueError("op take2 needs the lo lane, and only take2 takes it")
    if lo is not None:
        check_words(lo, "tile_stages")
        if lo.shape != h.shape or lo.device != h.device:
            raise ValueError("lo must match h in shape and device")
    if shifts.dtype != torch.int32 or shifts.dim() != 1:
        raise TypeError("shifts must be a 1-D int32 tensor")
    if shifts.device != h.device or not shifts.is_contiguous():
        raise ValueError("shifts must be contiguous and on h's device")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    n_rows, lanes = h.shape
    if axis == 1 and lanes > GROUP:
        raise ValueError(f"axis 1 takes rows of at most {GROUP} lanes")
    if axis == 0 and not (0 < tile_rows <= GROUP and n_rows % tile_rows == 0):
        raise ValueError(f"axis 0 needs tiles of 1 to {GROUP} rows that "
                         f"divide {n_rows} rows, got {tile_rows}")


def tile_stages_reference(h: torch.Tensor, shifts: torch.Tensor, op: str,
                          axis: int, lo: torch.Tensor | None = None,
                          tile_rows: int | None = None):
    """Plain PyTorch version: ``torch.roll`` + ``torch.where`` per stage on
    int64 copies of the words (the shifts are read to the host)."""
    tile_rows = tile_rows or h.shape[0]
    _check(h, shifts, op, axis, lo, tile_rows)
    n_rows, lanes = h.shape
    rows = tile_rows if axis == 0 else n_rows
    x = to_u32(h).reshape(-1, rows, lanes)
    y = None if lo is None else to_u32(lo).reshape(-1, rows, lanes)
    for s in shifts.tolist():
        if op == "add1":
            x = (x + 1) & MASK32
            continue
        px = torch.roll(x, s, dims=1 + axis)
        if op == "take2":
            py = torch.roll(y, s, dims=1 + axis)
            take = (px < x) | ((px == x) & (py < y))
            x, y = torch.where(take, px, x), torch.where(take, py, y)
        elif op == "min":
            x = torch.minimum(px, x)
        elif op == "min_add1":
            x = (torch.minimum(px, x) + 1) & MASK32
        else:  # copy
            x = px
    out = from_u32(x.reshape(n_rows, lanes), h.dtype)
    if y is None:
        return out
    return out, from_u32(y.reshape(n_rows, lanes), lo.dtype)


def tile_stages(h: torch.Tensor, shifts: torch.Tensor, op: str, axis: int,
                lo: torch.Tensor | None = None, tile_rows: int | None = None):
    """The stage loop of the module docstring: ``h`` after the stages, or
    ``(h, lo)`` for ``take2``."""
    tile_rows = tile_rows or h.shape[0]
    _check(h, shifts, op, axis, lo, tile_rows)
    if h.device.type == "cpu":
        return tile_stages_reference(h, shifts, op, axis, lo, tile_rows)
    oh = torch.empty_like(h)
    ol = None if lo is None else torch.empty_like(lo)
    if h.numel():
        n_rows, lanes = h.shape
        _LIB.launch("tile_stages_launch", h.data_ptr(),
                    None if lo is None else lo.data_ptr(), oh.data_ptr(),
                    None if ol is None else ol.data_ptr(), shifts.data_ptr(),
                    shifts.numel(), OPS[op], n_rows, tile_rows, lanes, axis,
                    stream_of(h))
        tile_stages.launches += 1
    return oh if ol is None else (oh, ol)


tile_stages.launches = 0  # kernel launches (CUDA calls only)
