"""Correctness probes of ``scripts/probe_pallas.py``, ``probe_pallas2.py``
and ``probe_pallas3.py``: gathers, the dynamic roll, the in-kernel row
sort and dynamic-offset copies, at the scripts' shapes and inputs, each
held against the script's own numpy oracle and against the kernel's
plain version.  Each prints ``name: OK correct: True|False``.

The scripts asked whether Mosaic could compile each body on the TPU; on
the card the question is whether the hand-written kernel computes the
same thing.  ``jax.random`` inputs become seeded numpy draws.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.row_sort import row_sort, row_sort_reference
from ..kernels.segment_copy import (
    row_copy_plan, segment_copy, segment_copy_reference)
from ..kernels.tile_gather import tile_gather, tile_gather_reference
from ..kernels.tile_stages import tile_stages, tile_stages_reference
from ..kernels.words import to_u32
from .common import (
    Record, copy_library, host, max_abs_err, sort_ops, time_ms, words)

R, L = 64, 128
ITERS = 20

P1 = "scripts/probe_pallas.py:34"
P2 = "scripts/probe_pallas2.py:26"


def _record(name, kernel, site, device, run, plain, oracle, nbytes, ops,
            library, library_fn=None) -> Record:
    """``nbytes``, ``ops``, ``library``: see ``Record.own_times``."""
    got, ref = run(), plain()
    err = max_abs_err(got, ref)
    return Record(name, "capability", kernel, site, str(device),
                  correct=err == 0 and bool(oracle(got)), max_abs_err=err,
                  ms=time_ms(run, device, ITERS),
                  plain_ms=time_ms(plain, device, ITERS)).own_times(
        run, device, nbytes, ops, library, library_fn)


def _gather(name, site, device, x, idx, axis, oracle_axis=None):
    xt, it = words(x, device), words(idx, device)
    it64 = it.to(torch.int64)  # torch's gathers take int64 indices
    if oracle_axis is None:
        want = x.reshape(-1)[idx]
        library = "torch.take(x, idx)", lambda: torch.take(xt, it64)
    else:
        want = np.take_along_axis(x, idx, oracle_axis)
        library = (f"torch.gather(x, {axis}, idx)",
                   lambda: torch.gather(xt, axis, it64))
    # x and idx read, one word out per index; one address per word
    return _record(
        name, "tile_gather", site, device,
        lambda: tile_gather(xt, it, axis),
        lambda: tile_gather_reference(xt, it, axis),
        lambda got: np.array_equal(host(got, x.dtype), want),
        x.nbytes + 2 * idx.nbytes, idx.size, *library)


def gather_lanes(device):
    """probe_pallas.py (a1) k_gather_lanes, probe_pallas2.py k_gl."""
    x = np.arange(R * L, dtype=np.uint32).reshape(R, L)
    idx = np.random.default_rng(0).integers(0, L, (R, L)).astype(np.int32)
    return _gather("gather_lanes(take_along_axis axis=1)", f"{P1}; {P2}",
                   device, x, idx, 1, oracle_axis=1)


def gather_rows(device):
    """probe_pallas.py (a2) k_gather_rows, probe_pallas2.py k_gr."""
    x = np.arange(R * L, dtype=np.uint32).reshape(R, L)
    idx = np.random.default_rng(1).integers(0, R, (R, L)).astype(np.int32)
    return _gather("gather_rows(take_along_axis axis=0)", f"{P1}; {P2}",
                   device, x, idx, 0, oracle_axis=0)


def gather_flat_table(device):
    """probe_pallas.py (a3) k_gather_table: x[idx] from an [8, 128]
    table."""
    tab = np.arange(8 * 128, dtype=np.uint32).reshape(8, 128)
    idx = np.random.default_rng(2).integers(0, 8 * 128, (R, L)).astype(
        np.int32)
    return _gather("gather_flat_table(x[idx] 1D)", P1, device, tab, idx,
                   None)


def dynamic_roll_lanes(device):
    """probe_pallas.py (b) k_dynroll, probe_pallas2.py k_dr: a roll along
    lanes by a shift held on the device (3)."""
    x = np.arange(R * L, dtype=np.uint32).reshape(R, L)
    xt = words(x, device)
    shift = torch.tensor([3], dtype=torch.int32, device=device)
    return _record(
        "dynamic_roll_lanes(+3)", "tile_stages", f"{P1}; {P2}", device,
        lambda: tile_stages(xt, shift, "copy", 1),
        lambda: tile_stages_reference(xt, shift, "copy", 1),
        lambda got: np.array_equal(host(got), np.roll(x, 3, 1)),
        2 * x.nbytes + 4, 0, "torch.roll(x, 3, 1) (shift from the host)",
        lambda: torch.roll(xt, 3, 1))


def _sort(name, device, x):
    xt = words(x, device)
    unsigned = to_u32(xt)  # torch sorts int64, not uint32
    return _record(
        name, "row_sort", P2, device,
        lambda: row_sort(xt), lambda: row_sort_reference(xt),
        lambda got: np.array_equal(host(got), np.sort(x, axis=1)),
        2 * x.nbytes, sort_ops(x.size, x.shape[1]),
        "torch.sort(x, dim=-1) on the unsigned values as int64",
        lambda: torch.sort(unsigned, dim=-1))


def inkernel_sort_lanes(device):
    """probe_pallas2.py (g) k_sort: jnp.sort(x, axis=1) of the [64, 128]
    arange tile (already sorted) ..."""
    return _sort("inkernel_sort_lanes", device,
                 np.arange(R * L, dtype=np.uint32).reshape(R, L))


def inkernel_sort_lanes_random(device):
    """... and of a random tile, with words above 2^31, so the sort has
    work to do and unsigned order is checked."""
    x = np.random.default_rng(4).integers(0, 1 << 32, (R, L),
                                          dtype=np.uint64).astype(np.uint32)
    return _sort("inkernel_sort_lanes(random)", device, x)


def _copy(name, site, device, src, plan, want):
    st = words(src, device)

    def run():
        return segment_copy(st, plan)

    def plain():
        return segment_copy_reference(st, plan)

    # the destination written once (zeros where no copy lands), the words
    # that stand in it read once, two offsets per copy
    return _record(name, "segment_copy", site, device, run, plain,
                   lambda got: np.array_equal(host(got), want.reshape(-1)),
                   4 * plan.n_out + 4 * want.size + 16 * plan.copies, 0,
                   *copy_library(st, plan))


def dyn_dma_prefetch(device):
    """probe_pallas2.py (f) k_dma: four copies of 4 rows of a [256, 256]
    source at row offsets off // 256 into the same [4, 256] block.  The
    TPU ran the grid in order, so the last copy (offset 40000) stands;
    the plan sees the overlap, and the kernel resolves each word's last
    writer."""
    src = np.arange(1 << 16, dtype=np.uint32).reshape(256, 256)
    offs = np.array([13, 1029, 777, 40000]) // 256
    plan = row_copy_plan(offs, np.zeros(4, np.int64), 4, 256, 256, 4,
                         device=device)
    want = src.reshape(-1)[(40000 // 256) * 256:][:1024]
    return _copy("dyn_dma_prefetch", "scripts/probe_pallas2.py:179", device,
                 src, plan, want)


def dyn_dma_smem_offsets(device):
    """probe_pallas3.py (3) k_dma: 8 rows of a [128, 128] source at row
    offsets (96, 0, 24, 64) into output block i."""
    src = np.arange(1 << 14, dtype=np.uint32).reshape(128, 128)
    offs = np.array([96, 0, 24, 64])
    plan = row_copy_plan(offs, 8 * np.arange(4), 8, 128, 128, 32,
                         device=device)
    want = np.concatenate([src[o: o + 8] for o in offs])
    return _copy("dyn_dma_smem_offsets", "scripts/probe_pallas3.py:151",
                 device, src, plan, want)


def _gather_axis0(rows, dtype):
    def probe(device):
        """probe_pallas3.py (1) kg: take_along_axis axis 0."""
        x = np.arange(rows * L).reshape(rows, L).astype(dtype)
        idx = np.random.default_rng(rows).integers(0, rows, (rows, L)).astype(
            np.int32)
        return _gather(f"gather_axis0 R={rows} {np.dtype(dtype).name}",
                       "scripts/probe_pallas3.py:55", device, x, idx, 0,
                       oracle_axis=0)
    return probe


def gather_axis0_via_transpose(device):
    """probe_pallas3.py kt: transpose, gather along lanes, transpose back:
    the same result as an axis-0 gather."""
    x = np.arange(R * L, dtype=np.uint32).reshape(R, L)
    idx = np.random.default_rng(3).integers(0, R, (R, L)).astype(np.int32)
    xt, it = words(x.T.copy(), device), words(idx.T.copy(), device)
    it64 = it.to(torch.int64)
    return _record(
        "gather_axis0_via_transpose", "tile_gather",
        "scripts/probe_pallas3.py:70", device,
        lambda: tile_gather(xt, it, 1).T,
        lambda: tile_gather_reference(xt, it, 1).T,
        lambda got: np.array_equal(host(got), np.take_along_axis(x, idx, 0)),
        x.nbytes + 2 * idx.nbytes, idx.size,
        "torch.gather(x.T, 1, idx.T).T", lambda: torch.gather(xt, 1, it64).T)


PROBES = [
    gather_lanes,
    gather_rows,
    gather_flat_table,
    dynamic_roll_lanes,
    inkernel_sort_lanes,
    inkernel_sort_lanes_random,
    dyn_dma_prefetch,
    _gather_axis0(8, np.int32),
    _gather_axis0(64, np.int32),
    _gather_axis0(512, np.uint32),
    _gather_axis0(64, np.float32),
    gather_axis0_via_transpose,
    dyn_dma_smem_offsets,
]


def run(device: torch.device, small: bool = False, workdir=None):
    """Yields the Record of every probe (``small`` changes nothing here:
    the shapes are already small)."""
    for probe in PROBES:
        yield probe(device)
