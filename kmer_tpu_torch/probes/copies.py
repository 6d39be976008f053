"""Dynamic-offset copy families of ``scripts/probe_r3a.py`` F and
``scripts/probe_r3b.py`` 1a-1e, at their G x SEG shapes, on the card.

Each prints the kernel's and the plain version's ms, copies/s and GB/s
(bytes read + written), and the kernel's destination must equal the
plain version's.  The sources are seeded random words of the scripts'
sizes (r3a: the extracted lane of 1M x 150 bp reads cut to a multiple of
130 * 8192 words; r3b: 130 * 2^20 words), and the offsets seeded numpy
draws of the scripts' ranges.

The TPU issued r3a's and r3b's loop copies from one grid step, one after
another (1c start/wait; r3a and 1e double-buffered); those plans keep
the name ``serial``, and r3a's families are also run as ``grid`` plans,
the TPU's one grid step a copy.  On the card both run every copy at once
(their destinations do not overlap, so that is the in-order result), the
shape a partition sort's redistribution would take.  ``small`` divides
the sources and the copy counts by 64 for a quick run on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.segment_copy import (
    copy_plan, row_copy_plan, segment_copy, segment_copy_reference)
from .common import Record, copy_library, max_abs_err, time_ms

R3A_WORDS = ((1 << 20) * 150 // (130 << 13)) * (130 << 13)  # 156,549,120
R3B_WORDS = 130 << 20  # 136,314,880 = 1,064,960 rows of 128
R3A_SHAPES = ((4096, 1024), (4096, 2048), (16384, 1024), (16384, 2048),
              (16384, 8192), (32768, 1024))
R3B_GRID2D = ((1024, 8), (16384, 8), (16384, 12), (131072, 8))
R3B_LOOP2D = ((16384, 8), (131072, 8))


def _copy(name, site, device, src, plan) -> Record:
    out_k = torch.zeros(plan.n_out, dtype=src.dtype, device=device)
    out_p = torch.zeros_like(out_k)
    err = max_abs_err(segment_copy(src, plan, out_k),
                      segment_copy_reference(src, plan, out_p))
    iters = 20 if plan.copies * plan.seg <= 1 << 20 else 3
    nbytes = 2 * 4 * plan.copies * plan.seg
    return Record(
        name, "copies", "segment_copy", site, str(device), correct=err == 0,
        max_abs_err=err,
        ms=time_ms(lambda: segment_copy(src, plan, out_k), device, iters),
        plain_ms=time_ms(lambda: segment_copy_reference(src, plan, out_p),
                         device, 1),
        copies=plan.copies, nbytes=nbytes).own_times(
        lambda: segment_copy(src, plan, out_k), device,
        nbytes + 16 * plan.copies, 0, *copy_library(src, plan))


def source(n: int, device: torch.device, seed: int = 0) -> torch.Tensor:
    """``n`` seeded random 32-bit words made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                         device=device, generator=gen)


def run(device: torch.device, small: bool = False, workdir=None):
    """Yields the Record of every copy family."""
    cut = 64 if small else 1
    src = source(R3A_WORDS // cut, device)
    n = src.numel()
    rng = np.random.default_rng(1)
    for g, seg in R3A_SHAPES:
        g //= cut
        if g * seg > n:  # the script skips these too
            continue
        in_off = rng.integers(0, n - seg, g)
        out_off = np.arange(g) * seg
        for serial, mode in ((True, ""), (False, "_grid")):
            plan = copy_plan(in_off, out_off, seg, n, g * seg, serial=serial,
                             device=device)
            yield _copy(f"F_dma_G{g}_SEG{seg}{mode}",
                        "scripts/probe_r3a.py:160", device, src, plan)

    src = src[: R3B_WORDS // cut]
    n = src.numel()
    m = n // 128
    rng = np.random.default_rng(0)
    site = "scripts/probe_r3b.py"
    yield _copy("J_dma_static_1d_single", f"{site}:109", device, src,
                copy_plan([0], [0], 1024, n, 1024, device=device))
    yield _copy("J_dma_dyn_1d_single", f"{site}:128", device, src,
                copy_plan([12345], [0], 1024, n, 1024, device=device))
    g, seg = 256, 1024
    yield _copy("J_dma_loop_1d_G256", f"{site}:153", device, src,
                copy_plan(rng.integers(0, n - seg, g), np.arange(g) * seg,
                          seg, n, g * seg, serial=True, device=device))
    for families, serial, line, label in (
            (R3B_GRID2D, False, 179, "K_dma_grid2d"),
            (R3B_LOOP2D, True, 218, "L_dma_loop2d")):
        for g, rows in families:
            g //= cut
            if g * rows > m:
                continue
            plan = row_copy_plan(rng.integers(0, m - rows, g),
                                 np.arange(g) * rows, rows, 128, m, g * rows,
                                 serial=serial, device=device)
            yield _copy(f"{label}_G{g}_rows{rows}", f"{site}:{line}", device,
                        src[: m * 128], plan)
