"""The port's probe kernels (plain versions, the CPU path of their wrappers)
vs the Pallas probe bodies of ``scripts/``, run in interpret mode.

The probe scripts claim a device and run when imported, so each Pallas
body is copied here, with its script line named, and run through
``pl.pallas_call(..., interpret=True)`` at a small shape (a few tiles of
16 to 64 rows, 9 stages).  Every comparison is exact: the results are
32-bit words.  The CUDA kernels are compared with their plain versions on
the card (``chip_smoke.py`` and ``tests/test_torch_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from kmer_tpu_torch.kernels.row_sort import row_sort, row_sort_reference
from kmer_tpu_torch.kernels.segment_copy import (
    copy_plan, row_copy_plan, segment_copy, segment_copy_reference)
from kmer_tpu_torch.kernels.tile_gather import (
    tile_gather, tile_gather_reference)
from kmer_tpu_torch.kernels.tile_stages import (
    tile_stages, tile_stages_reference)
from kmer_tpu_torch.probes import capability, copies, rates, run_all

L = 128
STAGES = 9
VM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _u32(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    """numpy words -> torch (uint32 travels as int32 bits)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _np(t, dtype=np.uint32):
    return t.contiguous().numpy().view(dtype)


def _call(kernel, out_shape, *args, **kw):
    return pl.pallas_call(kernel, out_shape=out_shape, interpret=True,
                          **kw)(*args)


def _shape(rows, dtype=jnp.uint32):
    return jax.ShapeDtypeStruct((rows, L), dtype)


def _doubling(n, mod=7, base=1, sign=1):
    return torch.tensor([sign * (base << (s % mod)) for s in range(n)],
                        dtype=torch.int32)


# --- gathers -----------------------------------------------------------


def k_gather_lanes(x_ref, i_ref, o_ref):  # scripts/probe_pallas.py:49
    o_ref[...] = jnp.take_along_axis(x_ref[...], i_ref[...], axis=1)


def k_gather_rows(x_ref, i_ref, o_ref):  # scripts/probe_pallas.py:61
    o_ref[...] = jnp.take_along_axis(x_ref[...], i_ref[...], axis=0)


def k_gather_table(t_ref, i_ref, o_ref):  # scripts/probe_pallas.py:74
    t = t_ref[...].reshape(-1)
    o_ref[...] = t[i_ref[...]]


@pytest.mark.parametrize("form", ["lanes", "rows", "table"])
def test_gather_matches_pallas(form):
    rows = 16
    x = _u32((8, L) if form == "table" else (rows, L), 10)
    bound = {"lanes": L, "rows": rows, "table": 8 * L}[form]
    idx = np.random.default_rng(11).integers(0, bound, (rows, L)).astype(
        np.int32)
    kernel = {"lanes": k_gather_lanes, "rows": k_gather_rows,
              "table": k_gather_table}[form]
    want = np.asarray(_call(kernel, _shape(rows), jnp.asarray(x),
                            jnp.asarray(idx), in_specs=[VM, VM],
                            out_specs=VM))
    axis = {"lanes": 1, "rows": 0, "table": None}[form]
    got = tile_gather_reference(_t(x), _t(idx), axis)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(tile_gather(_t(x), _t(idx), axis)),
                                  want)
    oracle = (x.reshape(-1)[idx] if axis is None
              else np.take_along_axis(x, idx, axis))
    np.testing.assert_array_equal(want, oracle)


def kg(x_ref, i_ref, o_ref):  # scripts/probe_pallas3.py:53
    o_ref[...] = jnp.take_along_axis(x_ref[...], i_ref[...], axis=0)


@pytest.mark.parametrize("rows, dtype", [(8, np.int32), (16, np.uint32),
                                         (64, np.float32)])
def test_gather_axis0_dtypes_match_pallas(rows, dtype):
    x = np.arange(rows * L).reshape(rows, L).astype(dtype)
    idx = np.random.default_rng(rows).integers(0, rows, (rows, L)).astype(
        np.int32)
    want = np.asarray(_call(kg, jax.ShapeDtypeStruct((rows, L), dtype),
                            jnp.asarray(x), jnp.asarray(idx),
                            in_specs=[VM, VM], out_specs=VM))
    got = tile_gather_reference(_t(x), _t(idx), 0)
    assert got.dtype == _t(x).dtype
    np.testing.assert_array_equal(_np(got, dtype), want)
    np.testing.assert_array_equal(want, np.take_along_axis(x, idx, 0))


def kt(x_ref, i_ref, o_ref):  # scripts/probe_pallas3.py:65
    xt = x_ref[...].T  # [L, R]
    it = i_ref[...].T
    g = jnp.take_along_axis(xt, it, axis=1)
    o_ref[...] = g.T


def test_gather_axis0_via_transpose_matches_pallas():
    rows = 16
    x = np.arange(rows * L, dtype=np.uint32).reshape(rows, L)
    idx = np.random.default_rng(3).integers(0, rows, (rows, L)).astype(
        np.int32)
    want = np.asarray(_call(kt, _shape(rows), jnp.asarray(x),
                            jnp.asarray(idx), in_specs=[VM, VM],
                            out_specs=VM))
    got = tile_gather_reference(_t(x.T.copy()), _t(idx.T.copy()), 1).T
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(want, np.take_along_axis(x, idx, 0))


# --- rolls and stage loops ----------------------------------------------


def k_dynroll(x_ref, s_ref, o_ref):  # scripts/probe_pallas.py:87
    o_ref[...] = pltpu.roll(x_ref[...], s_ref[0, 0], axis=1)


def k_dr(s_ref, x_ref, o_ref):  # scripts/probe_pallas2.py:62
    o_ref[...] = pltpu.roll(x_ref[...], s_ref[0], axis=1)


@pytest.mark.parametrize("shift", [3, 0, 127])
@pytest.mark.parametrize("body", ["k_dynroll", "k_dr"])
def test_dynamic_roll_matches_pallas(body, shift):
    rows = 16
    x = np.arange(rows * L, dtype=np.uint32).reshape(rows, L)
    if body == "k_dynroll":
        want = _call(k_dynroll, _shape(rows), jnp.asarray(x),
                     jnp.asarray([[shift]], jnp.int32),
                     in_specs=[VM, pl.BlockSpec((1, 1),
                                                memory_space=pltpu.SMEM)],
                     out_specs=VM)
    else:
        want = _call(k_dr, _shape(rows), jnp.asarray([shift], jnp.int32),
                     jnp.asarray(x),
                     in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), VM],
                     out_specs=VM)
    sched = torch.tensor([shift], dtype=torch.int32)
    got = tile_stages_reference(_t(x), sched, "copy", 1)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(want), np.roll(x, shift, 1))


def _cmpex_body(roll, stages):
    """The 2-lane compare-exchange loop of scripts/probe_pallas.py:102
    (k_vpu) and scripts/probe_pallas2.py:99-136 (k_roll_lanes,
    k_ptpu_roll_lanes, k_roll_rows, k_concat_rows), with the partner
    function of each and its stage count cut to ``stages``."""
    def kernel(h_ref, l_ref, oh, ol):
        h, l = h_ref[...], l_ref[...]
        for s in range(stages):
            d = 1 << (s % 7)
            ph, plo = roll(h, d), roll(l, d)
            take = (ph < h) | ((ph == h) & (plo < l))
            h = jnp.where(take, ph, h)
            l = jnp.where(take, plo, l)
        oh[...] = h
        ol[...] = l
    return kernel


CMPEX = {
    # name: (partner as in the script, port axis, port shift sign)
    "k_vpu": (lambda v, d: pltpu.roll(v, d, axis=1), 1, 1),
    "k_roll_lanes": (lambda v, d: jnp.roll(v, d, axis=1), 1, 1),
    "k_ptpu_roll_lanes": (lambda v, d: pltpu.roll(v, d, axis=1), 1, 1),
    "k_roll_rows": (lambda v, d: jnp.roll(v, d, axis=0), 0, 1),
    "k_concat_rows": (lambda v, d: jnp.concatenate([v[d:], v[:d]], axis=0),
                      0, -1),
}


@pytest.mark.parametrize("name", sorted(CMPEX))
def test_cmpex_stages_match_pallas(name):
    rows = 16
    roll, axis, sign = CMPEX[name]
    h, lo = _u32((rows, L), 20), _u32((rows, L), 21)
    h[:, ::3] = lo[:, ::5] = 7  # ties on h, so the lo lane decides some
    wh, wl = _call(_cmpex_body(roll, STAGES), [_shape(rows)] * 2,
                   jnp.asarray(h), jnp.asarray(lo), in_specs=[VM, VM],
                   out_specs=[VM, VM])
    gh, gl = tile_stages_reference(_t(h), _doubling(STAGES, sign=sign),
                                   "take2", axis, lo=_t(lo))
    np.testing.assert_array_equal(_np(gh), np.asarray(wh))
    np.testing.assert_array_equal(_np(gl), np.asarray(wl))


def k_roll_rows1(h_ref, oh):  # scripts/probe_pallas2.py:151
    h = h_ref[...]
    for s in range(STAGES):
        d = 1 << (s % 7)
        ph = jnp.roll(h, d, axis=0)
        h = jnp.minimum(ph, h)
    oh[...] = h


def test_min_rows_one_lane_matches_pallas():
    rows = 64
    h = _u32((rows, L), 30)
    want = _call(k_roll_rows1, _shape(rows), jnp.asarray(h), in_specs=[VM],
                 out_specs=VM)
    got = tile_stages_reference(_t(h), _doubling(STAGES), "min", 0)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def k0(x_ref, o_ref):  # scripts/probe_pallas3.py:30
    o_ref[...] = x_ref[...] + 1


def test_dispatch_add_matches_pallas():
    x = _u32((8, L), 31)
    x[0, :4] = 0xFFFFFFFF  # + 1 wraps
    want = _call(k0, _shape(8), jnp.asarray(x), in_specs=[VM], out_specs=VM)
    got = tile_stages_reference(_t(x), torch.zeros(1, dtype=torch.int32),
                                "add1", 1)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# the amplified loops of scripts/probe_pallas3.py:97-131 and
# scripts/probe_r2.py:143-163, on a grid of tiles, steps cut to STAGES


def k_cmpex1(x_ref, o_ref):  # scripts/probe_pallas3.py:97
    h = x_ref[...]
    for s in range(STAGES):
        d = 1 << (s % 7)
        ph = jnp.roll(h, d, axis=1)
        h = jnp.minimum(ph, h) + 1
    o_ref[...] = h


def k_cmpex1r(x_ref, o_ref):  # scripts/probe_pallas3.py:106
    h = x_ref[...]
    for s in range(STAGES):
        d = 1 << (s % 7)
        ph = jnp.roll(h, d, axis=0)
        h = jnp.minimum(ph, h) + 1
    o_ref[...] = h


def k_add(x_ref, o_ref):  # scripts/probe_pallas3.py:131
    h = x_ref[...]
    for s in range(STAGES):
        h = h + 1
    o_ref[...] = h


def k_cmpex(x_ref, o_ref):  # scripts/probe_r2.py:143
    h = x_ref[...]
    for s in range(STAGES):
        d = 1 << (s % 7)
        sh = jnp.concatenate([h[:, d:], h[:, :d]], axis=1)
        h = jnp.minimum(h, sh) + jnp.uint32(1)
    o_ref[...] = h


def k_cmpex0(x_ref, o_ref):  # scripts/probe_r2.py:157
    h = x_ref[...]
    for s in range(STAGES):
        d = 8 << (s % 4)
        sh = jnp.concatenate([h[d:], h[:d]], axis=0)
        h = jnp.minimum(h, sh) + jnp.uint32(1)
    o_ref[...] = h


AMPLIFIED = {
    # name: (body, op, axis, shift schedule)
    "k_cmpex1": (k_cmpex1, "min_add1", 1, _doubling(STAGES)),
    "k_cmpex1r": (k_cmpex1r, "min_add1", 0, _doubling(STAGES)),
    "k_add": (k_add, "add1", 1, torch.zeros(STAGES, dtype=torch.int32)),
    "k_cmpex": (k_cmpex, "min_add1", 1, _doubling(STAGES, sign=-1)),
    "k_cmpex0": (k_cmpex0, "min_add1", 0,
                 _doubling(STAGES, mod=4, base=8, sign=-1)),
}


def _grid_call(body, tiles, br, *args):
    spec = pl.BlockSpec((br, L), lambda i: (i, 0), memory_space=pltpu.VMEM)
    return np.asarray(_call(body, _shape(tiles * br), *args, grid=(tiles,),
                            in_specs=[spec] * len(args), out_specs=spec))


@pytest.mark.parametrize("name", sorted(AMPLIFIED))
def test_amplified_stages_match_pallas(name):
    tiles, br = 3, 64
    body, op, axis, sched = AMPLIFIED[name]
    x = _u32((tiles * br, L), 40)
    x[:2, :5] = 0xFFFFFFFF  # + 1 wraps
    want = _grid_call(body, tiles, br, jnp.asarray(x))
    got = tile_stages_reference(_t(x), sched, op, axis, tile_rows=br)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(tile_stages(_t(x), sched, op, axis, tile_rows=br)), want)


def k_gather1(x_ref, i_ref, o_ref):  # scripts/probe_pallas3.py:115
    h = x_ref[...]
    i = i_ref[...] % L
    for s in range(STAGES):
        h = jnp.take_along_axis(h, i, axis=1) + 1
    o_ref[...] = h


def k_gather0(x_ref, i_ref, o_ref):  # scripts/probe_pallas3.py:123
    h = x_ref[...]
    i = i_ref[...]  # already < BR
    for s in range(STAGES):
        h = jnp.take_along_axis(h, i, axis=0) + 1
    o_ref[...] = h


@pytest.mark.parametrize("axis", [1, 0])
def test_amplified_gather_matches_pallas(axis):
    tiles, br = 3, 16
    x = _u32((tiles * br, L), 50)
    idx = (_u32((tiles * br, L), 51) % br).astype(np.int32)
    body = k_gather1 if axis == 1 else k_gather0
    want = _grid_call(body, tiles, br, jnp.asarray(x), jnp.asarray(idx))
    port_idx = idx % L if axis == 1 else idx
    got = tile_gather_reference(_t(x), _t(port_idx), axis, tile_rows=br,
                                steps=STAGES, add=1)
    np.testing.assert_array_equal(_np(got), want)


# --- row sort ----------------------------------------------------------


def k_sort(x_ref, o_ref):  # scripts/probe_pallas2.py:74
    o_ref[...] = jnp.sort(x_ref[...], axis=1)


@pytest.mark.parametrize("data", ["arange", "random"])
def test_row_sort_matches_pallas(data):
    rows = 16
    x = (np.arange(rows * L, dtype=np.uint32).reshape(rows, L)[:, ::-1].copy()
         if data == "arange" else _u32((rows, L), 60))
    want = np.asarray(_call(k_sort, _shape(rows), jnp.asarray(x),
                            in_specs=[VM], out_specs=VM))
    np.testing.assert_array_equal(_np(row_sort_reference(_t(x))), want)
    np.testing.assert_array_equal(_np(row_sort(_t(x))), want)
    np.testing.assert_array_equal(want, np.sort(x, axis=1))


# --- dynamic-offset copies ---------------------------------------------


def test_dma_prefetch_last_writer_matches_pallas():
    """scripts/probe_pallas2.py:165 k_dma: four grid steps copy into the
    same block; the TPU ran them in order, so the last one stands."""
    ch = 1024
    src = np.arange(1 << 16, dtype=np.uint32).reshape(256, 256)
    offs = np.array([13, 1029, 777, 40000], np.int32)

    def k_dma(off_ref, src_ref, o_ref, sem):
        i = pl.program_id(0)
        start = off_ref[i] // 256  # row index
        cp = pltpu.make_async_copy(src_ref.at[pl.ds(start, ch // 256)],
                                   o_ref, sem)
        cp.start()
        cp.wait()

    gs = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(4,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((ch // 256, 256), lambda i, off: (0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.SemaphoreType.DMA(())])
    want = np.asarray(pl.pallas_call(
        k_dma, grid_spec=gs, interpret=True,
        out_shape=jax.ShapeDtypeStruct((ch // 256, 256), jnp.uint32))(
            jnp.asarray(offs), jnp.asarray(src)))
    plan = row_copy_plan(offs // 256, np.zeros(4), 4, 256, 256, 4)
    assert plan.overlap  # the last writer decides, as the TPU's order did
    got = segment_copy_reference(_t(src), plan)
    np.testing.assert_array_equal(_np(got).reshape(4, 256), want)
    np.testing.assert_array_equal(
        want, src.reshape(-1)[(40000 // 256) * 256:][:ch].reshape(4, 256))


def test_dma_smem_offsets_match_pallas():
    """scripts/probe_pallas3.py:142 k_dma: 8 rows at SMEM row offsets."""
    src = np.arange(1 << 14, dtype=np.uint32).reshape(128, 128)
    offs = np.array([96, 0, 24, 64], np.int32)

    def k_dma(off_ref, src_ref, o_ref):
        i = pl.program_id(0)

        def body(scr, sem):
            cp = pltpu.make_async_copy(src_ref.at[pl.ds(off_ref[i], 8)], scr,
                                       sem)
            cp.start()
            cp.wait()
            o_ref[...] = scr[...]
        pl.run_scoped(body, scr=pltpu.VMEM((8, 128), jnp.uint32),
                      sem=pltpu.SemaphoreType.DMA(()))

    want = np.asarray(pl.pallas_call(
        k_dma, grid=(4,), interpret=True,
        out_shape=jax.ShapeDtypeStruct((32, 128), jnp.uint32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM))(
            jnp.asarray(offs), jnp.asarray(src)))
    plan = row_copy_plan(offs, 8 * np.arange(4), 8, 128, 128, 32)
    assert not plan.serial and not plan.overlap
    got = segment_copy_reference(_t(src), plan)
    np.testing.assert_array_equal(_np(got).reshape(32, 128), want)
    np.testing.assert_array_equal(
        want, np.concatenate([src[o: o + 8] for o in offs]))


def make_copier(G, SEG, n_in, n_out, double=True):
    """scripts/probe_r3a.py:134, verbatim."""
    def kernel(in_off_ref, out_off_ref, in_ref, out_ref):
        def body(sem):
            def get_dma(g, slot):
                return pltpu.make_async_copy(
                    in_ref.at[pl.ds(in_off_ref[g], SEG)],
                    out_ref.at[pl.ds(out_off_ref[g], SEG)],
                    sem.at[slot],
                )
            if double:
                get_dma(0, 0).start()

                def loop(g, _):
                    @pl.when(g + 1 < G)
                    def _():
                        get_dma(g + 1, (g + 1) % 2).start()
                    get_dma(g, g % 2).wait()
                    return 0
                jax.lax.fori_loop(0, G, loop, 0)
            else:
                def loop(g, _):
                    d = get_dma(g, 0)
                    d.start()
                    d.wait()
                    return 0
                jax.lax.fori_loop(0, G, loop, 0)
        pl.run_scoped(body, pltpu.SemaphoreType.DMA((2,)))

    return pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=2,
            grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pl.ANY),
        ),
        out_shape=jax.ShapeDtypeStruct((n_out,), jnp.uint32),
        compiler_params=pltpu.CompilerParams(has_side_effects=True),
        interpret=True,
    )


def _row_copier(G, segrows, n_out_rows, grid_per_copy):
    """scripts/probe_r3b.py:170 mk_grid2d (one grid step a copy) and
    :201 mk_loop2d (double-buffered loop in one step)."""
    def grid_kernel(in_off_ref, out_off_ref, in_ref, out_ref):
        g = pl.program_id(0)

        def body(sem):
            d = pltpu.make_async_copy(
                in_ref.at[pl.ds(in_off_ref[g], segrows), :],
                out_ref.at[pl.ds(out_off_ref[g], segrows), :], sem)
            d.start()
            d.wait()
        pl.run_scoped(body, pltpu.SemaphoreType.DMA(()))

    def loop_kernel(in_off_ref, out_off_ref, in_ref, out_ref):
        def body(sem):
            def get(g, slot):
                return pltpu.make_async_copy(
                    in_ref.at[pl.ds(in_off_ref[g], segrows), :],
                    out_ref.at[pl.ds(out_off_ref[g], segrows), :],
                    sem.at[slot])
            get(0, 0).start()

            def loop(g, _):
                @pl.when(g + 1 < G)
                def _():
                    get(g + 1, (g + 1) % 2).start()
                get(g, g % 2).wait()
                return 0
            jax.lax.fori_loop(0, G, loop, 0)
        pl.run_scoped(body, pltpu.SemaphoreType.DMA((2,)))

    return pl.pallas_call(
        grid_kernel if grid_per_copy else loop_kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=2, grid=(G,) if grid_per_copy else (1,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pl.ANY)),
        out_shape=jax.ShapeDtypeStruct((n_out_rows, 128), jnp.uint32),
        compiler_params=pltpu.CompilerParams(has_side_effects=True),
        interpret=True,
    )


@pytest.mark.parametrize("double", [True, False])
def test_copier_matches_pallas(double):
    """r3a's copier (and r3b 1c mk_loop1d, its serial form)."""
    g, seg, n = 6, 40, 1000
    src = _u32(n, 70)
    rng = np.random.default_rng(71)
    in_off = rng.integers(0, n - seg, g).astype(np.int32)
    in_off[-1] = n - seg  # a copy that ends at the source's last word
    out_off = (np.arange(g) * seg).astype(np.int32)
    want = np.asarray(make_copier(g, seg, n, g * seg, double)(
        jnp.asarray(in_off), jnp.asarray(out_off), jnp.asarray(src)))
    plan = copy_plan(in_off, out_off, seg, n, g * seg, serial=True)
    got = segment_copy_reference(_t(src), plan)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        want, np.concatenate([src[o: o + seg] for o in in_off]))


@pytest.mark.parametrize("grid_per_copy", [True, False])
def test_row_copies_match_pallas(grid_per_copy):
    g, segrows, m = 5, 3, 40
    src = _u32((m, 128), 80)
    rng = np.random.default_rng(81)
    in_rows = rng.integers(0, m - segrows, g).astype(np.int32)
    out_rows = (np.arange(g) * segrows).astype(np.int32)
    want = np.asarray(_row_copier(g, segrows, g * segrows, grid_per_copy)(
        jnp.asarray(in_rows), jnp.asarray(out_rows), jnp.asarray(src)))
    plan = row_copy_plan(in_rows, out_rows, segrows, 128, m, g * segrows,
                         serial=not grid_per_copy)
    got = segment_copy(_t(src), plan)
    np.testing.assert_array_equal(_np(got).reshape(-1, 128), want)


@pytest.mark.parametrize("offset", [0, 12345 % 1000])
def test_single_copy_matches_pallas(offset):
    """scripts/probe_r3b.py:99 mk_static1d (offset 0) and :120 mk_dyn1d
    (a prefetched offset), one copy of SEG words."""
    seg, n = 64, 1000
    src = _u32(n, 90)

    def kernel(off_ref, in_ref, out_ref):
        def body(sem):
            d = pltpu.make_async_copy(in_ref.at[pl.ds(off_ref[0], seg)],
                                      out_ref.at[pl.ds(0, seg)], sem)
            d.start()
            d.wait()
        pl.run_scoped(body, pltpu.SemaphoreType.DMA(()))

    want = np.asarray(pl.pallas_call(
        kernel, interpret=True,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec(memory_space=pl.ANY)),
        out_shape=jax.ShapeDtypeStruct((seg,), jnp.uint32),
        compiler_params=pltpu.CompilerParams(has_side_effects=True))(
            jnp.asarray([offset], jnp.int32), jnp.asarray(src)))
    got = segment_copy_reference(_t(src), copy_plan([offset], [0], seg, n,
                                                    seg))
    np.testing.assert_array_equal(_np(got), want)


# --- the probe modules against the scripts' numpy oracles ----------------


@pytest.mark.parametrize("probe", capability.PROBES,
                         ids=lambda p: getattr(p, "__name__", "gather_axis0"))
def test_capability_probe_correct_on_cpu(probe):
    rec = probe(torch.device("cpu"))
    assert rec.correct and rec.max_abs_err == 0, rec
    assert "OK correct: True" in rec.line()


def test_copy_families_small_on_cpu():
    recs = list(copies.run(torch.device("cpu"), small=True))
    assert len(recs) == 21
    assert all(r.correct for r in recs), [r.name for r in recs
                                          if not r.correct]


def test_rate_probes_have_the_scripts_op_counts():
    """The amplified and r2 rates count words x stages as the scripts do."""
    recs = {r.name: r for r in rates.run(torch.device("cpu"), small=True)}
    assert all(r.correct for r in recs.values())
    assert recs["vpu_cmpex"].ops == 1024 * L * 64 * 1
    assert recs["cmpex_concat_rows"].ops == 1024 * L * 256
    assert recs["gather_rows(amplified)"].ops == 2 * 512 * L * 128
    assert recs["dispatch_overhead (8, 128)"].ops is None


def test_composed_families_are_bounded_by_bytes(monkeypatch):
    """add1's stages compose into one add a word and copy's into one roll,
    so at the amplified add's shape its bytes set the bound, where the
    script's stage count (words x stages) would have set an operation
    bound; the dependent stages keep their per-stage cost."""
    from kmer_tpu_torch.probes import common

    monkeypatch.setattr(common, "hbm_bytes_per_s", lambda device: 3.35e12)
    monkeypatch.setattr(common, "int32_ops_per_s",
                        lambda device: 132 * 64 * 1.98e9)
    dev = torch.device("cuda", 0)
    words, stages = 128 * 512 * L, 128
    assert rates.issued_ops("add1", words, stages) == words
    assert rates.issued_ops("copy", words, stages) == 0
    assert rates.issued_ops("min_add1", words, stages) == 2 * words * stages
    nbytes = 2 * 4 * words
    assert common.bound_ms(nbytes, rates.issued_ops("add1", words, stages),
                           dev)[1] == "bytes"
    assert common.bound_ms(nbytes, words * stages, dev)[1] == "operations"


def test_composed_add_rate_line_names_the_stage_count():
    """The add's G ops/s is the script's stage count, not issued work."""
    recs = {r.name: r for r in rates.run(torch.device("cpu"), small=True)}
    assert ("G stage-ops (the script's count, not issued operations)/s"
            in recs["plain_add(amplified)"].line())
    assert " G ops/s" in recs["vpu_cmpex"].line()


def test_run_all_echoes_one_line_per_probe():
    lines = []
    recs = run_all("cpu", only="capability", echo=lines.append)
    assert lines[0] == "== capability ==" and len(lines) == len(recs) + 1
    assert all(": OK correct: True" in ln for ln in lines[1:])


def test_card_only_fields_stay_empty_on_cpu():
    """A graph time, a bound and a library time are card numbers: a CPU
    run leaves them None and prints none of them."""
    recs = run_all("cpu", only="capability", echo=lambda _: None)
    recs += list(rates.run(torch.device("cpu"), small=True))[:2]
    for r in recs:
        assert (r.graph_ms, r.bound_ms, r.bound_by, r.library,
                r.library_ms) == (None,) * 5
        assert "graph" not in r.line()


def test_bound_is_the_larger_of_bytes_and_operations(monkeypatch):
    from kmer_tpu_torch.probes import common

    monkeypatch.setattr(common, "hbm_bytes_per_s", lambda device: 1e12)
    monkeypatch.setattr(common, "int32_ops_per_s", lambda device: 1e13)
    dev = torch.device("cuda", 0)
    assert common.bound_ms(10 ** 9, 10 ** 9, dev) == (1.0, "bytes")
    assert common.bound_ms(10 ** 6, 10 ** 11, dev) == (10.0, "operations")


_OFFS = np.random.default_rng(9).integers(0, 4000, 50)


@pytest.mark.parametrize("plan, reason", [
    (copy_plan(_OFFS, np.arange(50) * 33, 33, 4096, 50 * 33), None),
    (copy_plan([12], [0], 1024, 4096, 1024), None),
    (row_copy_plan(_OFFS[:8] % 30, np.arange(8) * 3, 3, L, 32, 24), None),
    (copy_plan([1, 2, 3], [0, 0, 0], 7, 4096, 7), "none: overlapping"),
    (copy_plan(_OFFS[:3], [66, 0, 33], 33, 4096, 99), "none: the dest"),
    (copy_plan([0], [0], 10, 4096, 20), "none: the dest"),
], ids=["r3a", "single", "rows", "overlap", "out_of_order", "gap"])
def test_copy_library_computes_the_plan_where_one_call_does(plan, reason):
    """The yardstick of a copy family is one ``index_select`` of the
    source's windows where the destinations fill the output in copy
    order, and "none" with the reason elsewhere."""
    from kmer_tpu_torch.probes.common import copy_library

    src = _t(_u32(4096, 8))
    label, fn = copy_library(src, plan)
    if reason is None:
        assert torch.equal(fn(), segment_copy_reference(src, plan))
    else:
        assert fn is None and label.startswith(reason)


# --- wrapper contracts ---------------------------------------------------


def test_plan_rejects_out_of_range_copies():
    with pytest.raises(ValueError, match="source"):
        copy_plan([991], [0], 10, 1000, 10)
    with pytest.raises(ValueError, match="destination"):
        copy_plan([0], [-1], 10, 1000, 10)
    with pytest.raises(ValueError, match="at least one word"):
        copy_plan([0], [0], 0, 1000, 10)


def test_plan_keeps_order_only_where_destinations_overlap():
    """``overlap``, which the kernel reads, is the plan's own finding;
    ``serial`` stays what the caller asked for."""
    plan = copy_plan([0, 5], [0, 9], 10, 100, 19)
    assert plan.overlap and not plan.serial
    assert not copy_plan([0, 5], [0, 10], 10, 100, 20).overlap
    plan = copy_plan([0, 5], [0, 10], 10, 100, 20, serial=True)
    assert plan.serial and not plan.overlap


@pytest.mark.parametrize("call, err", [
    (lambda: tile_gather(torch.zeros(4, L, dtype=torch.int64),
                         torch.zeros(4, L, dtype=torch.int32), 1), TypeError),
    (lambda: tile_gather(torch.zeros(4, L, dtype=torch.int32),
                         torch.zeros(4, L, dtype=torch.int64), 1), TypeError),
    (lambda: tile_gather(torch.zeros(6, L, dtype=torch.int32),
                         torch.zeros(6, L, dtype=torch.int32), 0,
                         tile_rows=4), ValueError),
    (lambda: tile_stages(torch.zeros(4, L, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), "take2", 1),
     ValueError),
    (lambda: tile_stages(torch.zeros(4, L, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), "max", 1),
     ValueError),
    (lambda: row_sort(torch.zeros(4, 96, dtype=torch.int32)), ValueError),
    (lambda: row_sort(torch.zeros(4, L, dtype=torch.int32)[:, ::2]),
     ValueError),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call, err):
    with pytest.raises(err):
        call()


def test_wrappers_on_cpu_launch_nothing():
    before = (tile_gather.launches, tile_stages.launches, row_sort.launches,
              segment_copy.launches)
    x = _t(_u32((8, L), 1))
    tile_gather(x, torch.zeros(8, L, dtype=torch.int32), 1)
    tile_stages(x, torch.ones(2, dtype=torch.int32), "min", 0)
    row_sort(x)
    segment_copy(x, copy_plan([0], [0], 8, 8 * L, 8))
    assert before == (tile_gather.launches, tile_stages.launches,
                      row_sort.launches, segment_copy.launches)
