"""Dynamic-offset segment copies of 32-bit words: the wrapper of the
hand-written CUDA kernel (``csrc/segment_copy.cu``), its plain PyTorch
version, and its launch count.

Replaces the Pallas probe DMAs: ``scripts/probe_pallas2.py`` and
``scripts/probe_pallas3.py`` ``k_dma``, ``scripts/probe_r3a.py``
``make_copier`` and ``scripts/probe_r3b.py`` ``mk_static1d``,
``mk_dyn1d``, ``mk_loop1d``, ``mk_grid2d`` and ``mk_loop2d``.

A ``CopyPlan`` holds G copies ``out[out_off[g] : out_off[g] + seg] =
src[in_off[g] : in_off[g] + seg]`` over flat word arrays, with the
offsets already on the device (the TPU kernels prefetched them as
scalars ahead of the grid).  The copies take effect in order: where two
destinations overlap, the later copy wins, as on the TPU, whose grid ran
in order.  ``copy_plan`` checks the offsets once on the host: every copy
must lie inside its array, and ``overlap`` records whether two
destinations overlap.  The kernel runs every copy at once across the
card either way; ``overlap`` alone chooses whether it first resolves each
word's last writer (see ``csrc/segment_copy.cu``).  ``serial`` keeps what
the caller asked for (the probes' "serial issue" of the TPU scripts) and
changes nothing in the result.  A copy of row blocks is the same copy
with offsets and length times the row width (``row_copy_plan``).

``segment_copy`` takes the plain version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises.  It refuses an
``out`` that shares storage with the source: copy g + 1 would then read
what copy g wrote, which the in-order result depends on and the kernel,
running every copy at once, does not reproduce.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .build import KernelLibrary
from .words import check_words, stream_of

_LIB = KernelLibrary("segment_copy", {
    "segment_copy_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p],
})


def build():
    """Build (if needed) and load the kernel library."""
    return _LIB.load()


@dataclasses.dataclass(frozen=True)
class CopyPlan:
    """G checked copies of ``seg`` words from an ``n_in``-word source into
    an ``n_out``-word destination; offsets are int64 [G] on the device.
    ``serial``: the caller asked for in-order issue (a label only);
    ``overlap``: two destinations overlap, so the last writer decides."""

    in_off: torch.Tensor
    out_off: torch.Tensor
    seg: int
    n_in: int
    n_out: int
    serial: bool
    overlap: bool

    @property
    def copies(self) -> int:
        return int(self.in_off.numel())


def copy_plan(in_off, out_off, seg: int, n_in: int, n_out: int,
              serial: bool = False, device: torch.device | str = "cpu"
              ) -> CopyPlan:
    """Checks host offsets (word units) and moves them to ``device``."""
    io = np.asarray(in_off, np.int64).reshape(-1)
    oo = np.asarray(out_off, np.int64).reshape(-1)
    if io.shape != oo.shape:
        raise ValueError(f"{io.size} source and {oo.size} destination "
                         "offsets")
    if seg < 1:
        raise ValueError(f"a copy moves at least one word, not {seg}")
    for what, off, n in (("source", io, n_in), ("destination", oo, n_out)):
        if io.size and (off.min() < 0 or off.max() + seg > n):
            raise ValueError(f"a {what} copy of {seg} words runs outside "
                             f"its {n} words")
    if io.size >= 1 << 31:
        raise ValueError(f"at most 2^31 - 1 copies, got {io.size}")
    return CopyPlan(
        in_off=torch.from_numpy(io).to(device),
        out_off=torch.from_numpy(oo).to(device),
        seg=int(seg), n_in=int(n_in), n_out=int(n_out), serial=bool(serial),
        overlap=bool((np.diff(np.sort(oo)) < seg).any()))


def row_copy_plan(in_rows, out_rows, seg_rows: int, width: int,
                  n_in_rows: int, n_out_rows: int, serial: bool = False,
                  device: torch.device | str = "cpu") -> CopyPlan:
    """A plan that copies blocks of ``seg_rows`` rows of ``width`` words,
    at row offsets, as flat copies."""
    return copy_plan(np.asarray(in_rows, np.int64) * width,
                     np.asarray(out_rows, np.int64) * width,
                     seg_rows * width, n_in_rows * width, n_out_rows * width,
                     serial, device)


def _check(src: torch.Tensor, plan: CopyPlan, out: torch.Tensor | None):
    check_words(src, "segment_copy", dim=None)
    if src.numel() != plan.n_in:
        raise ValueError(f"the plan copies from {plan.n_in} words, the "
                         f"source holds {src.numel()}")
    if plan.in_off.device != src.device:
        raise ValueError(f"plan on {plan.in_off.device}, source on "
                         f"{src.device}")
    if out is not None:
        check_words(out, "segment_copy", dim=None)
        if (out.numel() != plan.n_out or out.dtype != src.dtype
                or out.device != src.device):
            raise ValueError(f"out must hold {plan.n_out} words of the "
                             "source's dtype on its device")


def segment_copy_reference(src: torch.Tensor, plan: CopyPlan,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: one slice copy per copy, in order.  Returns
    the flat destination (zeros where nothing was copied, when ``out`` is
    not given)."""
    _check(src, plan, out)
    flat = src.reshape(-1)
    if out is None:
        out = torch.zeros(plan.n_out, dtype=src.dtype, device=src.device)
    dst = out.reshape(-1)
    seg = plan.seg
    for i, o in zip(plan.in_off.tolist(), plan.out_off.tolist()):
        dst[o: o + seg] = flat[i: i + seg]
    return out


def segment_copy(src: torch.Tensor, plan: CopyPlan,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Runs ``plan`` from ``src`` into ``out`` (default: a new zeroed
    destination, never one that shares storage with ``src``) and returns
    it."""
    _check(src, plan, out)
    if out is not None and (out.untyped_storage().data_ptr()
                            == src.untyped_storage().data_ptr()):
        raise ValueError("out shares storage with the source")
    if src.device.type == "cpu":
        return segment_copy_reference(src, plan, out)
    if out is None:
        out = torch.zeros(plan.n_out, dtype=src.dtype, device=src.device)
    if plan.copies:
        owner = (torch.empty(plan.n_out, dtype=torch.int32, device=src.device)
                 if plan.overlap else None)
        _LIB.launch("segment_copy_launch", src.data_ptr(), out.data_ptr(),
                    plan.in_off.data_ptr(), plan.out_off.data_ptr(),
                    None if owner is None else owner.data_ptr(), plan.seg,
                    plan.copies, plan.n_out, int(plan.overlap),
                    stream_of(src))
        segment_copy.launches += 1
    return out


segment_copy.launches = 0  # kernel launches (CUDA calls only)
