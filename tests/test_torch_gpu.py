"""The port's CUDA kernels vs their plain PyTorch versions, on a card.

Every test here carries the ``gpu`` marker and skips inside the test
where ``torch.cuda.is_available()`` is False.  The file imports no JAX,
so it runs on a machine with a card and no JAX:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py sets JAX up for the CPU suite).
Every comparison is exact: the results are integers or 32-bit words.
"""

import os

import numpy as np
import pytest
import torch

from kmer_tpu_torch.kernels.row_sort import (
    MAX_WIDTH, build as build_row_sort, row_sort, row_sort_reference)
from kmer_tpu_torch.kernels.segment_copy import (
    copy_plan, segment_copy, segment_copy_reference)
from kmer_tpu_torch.kernels.segment_counts import (
    segment_counts, segment_counts_reference, segment_counts_tile)
from kmer_tpu_torch.kernels.tile_gather import (
    tile_gather, tile_gather_reference)
from kmer_tpu_torch.kernels.tile_stages import (
    tile_stages, tile_stages_reference)
from kmer_tpu_torch.kernels.codes_keys import codes_keys, codes_keys_reference
from kmer_tpu_torch.kernels.wire_keys import (
    stream_keys, stream_keys_reference, wire_keys, wire_keys_reference)
from kmer_tpu_torch.kernels import launches
from kmer_tpu_torch.native import pack2bit_rows
from kmer_tpu_torch.packed import SIGN_FLIP
from kmer_tpu_torch.probes import PHASE_KERNELS
from kernel_edges import (
    CODES_KS, CODES_SHAPES, CODES_WIDTHS, EDGES, GATHER_SHAPES, GATHER_STEPS,
    GATHER_TABLES, LARGE, OVERLAP_PLANS, ROW_SORT_CASES, SCHEDULES,
    STAGE_SHAPES, STREAM_CASES, STREAM_KS, WIRE_KS, WIRE_WIDTHS, codes_case,
    codes_shape, edge_runs, gather_case, overlap_plan, row_sort_case,
    stage_shape_id, stream_case, wide_codes, wire_case)

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
@pytest.mark.parametrize("tiles, extra, distinct, sentinel", [
    (0, 1, 1, False), (0, 2, 2, False), (0, 5000, 7, False),
    (5, 7, 1, False), (0, 3000, 15, True), (256, 0, 1 << 18, True)])
def test_kernel_matches_reference_on_cuda(tiles, extra, distinct, sentinel):
    """The segment-count kernel, slot for slot, on sorted keys with bit 63
    set on some and (optionally) the folded all-ones sentinel; n is
    ``tiles`` of the built kernel's tile plus ``extra``."""
    dev = _cuda()
    n = tiles * segment_counts_tile() + extra
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


SEG_SENTINEL = 1 << 62


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("name", EDGES + LARGE)
def test_kernel_tile_edges_on_cuda(name, aligned):
    """The kernel equals the plain version at the edges of its tiles, on a
    16-byte-aligned tensor and on a view 8 bytes past one (``buf[1:]``),
    which the wrapper takes as it is."""
    dev = _cuda()
    lengths, sentinel_run = edge_runs(name, segment_counts_tile())
    host = np.r_[np.repeat(np.arange(lengths.size), lengths),
                 np.full(sentinel_run, SEG_SENTINEL)]
    sentinel = SEG_SENTINEL if sentinel_run else None
    n = host.size
    buf = torch.empty(n + 1, dtype=torch.int64, device=dev)
    keys = buf[:n] if aligned else buf[1:]
    keys.copy_(torch.from_numpy(host))
    assert keys.data_ptr() % 16 == (0 if aligned else 8)
    before = segment_counts.launches
    got, got_u = segment_counts(keys, sentinel)
    assert segment_counts.launches == before + 1
    ref, ref_u = segment_counts_reference(keys, sentinel)
    assert torch.equal(got, ref) and int(got_u) == int(ref_u)


@pytest.mark.gpu
def test_kernel_above_2_30_slots_on_cuda():
    """keys = arange(n) >> 10 with n above 2^30: every tail holds 1024, the
    last the remainder, n_unique = ceil(n / 1024).  Catches 32-bit slot or
    byte offsets (~13 GB on the card)."""
    dev = _cuda()
    n = (1 << 30) + 12345
    keys = torch.arange(n, dtype=torch.int64, device=dev) >> 10
    before = segment_counts.launches
    counts, n_unique = segment_counts(keys)
    assert segment_counts.launches == before + 1
    del keys
    full = n // 1024 * 1024
    blocks = counts[:full].view(-1, 1024)
    assert bool((blocks[:, :1023] == 0).all())
    assert bool((blocks[:, 1023] == 1024).all())
    rest = counts[full:]
    assert bool((rest[:-1] == 0).all()) and int(rest[-1]) == n - full
    assert int(n_unique) == -(-n // 1024)


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
@pytest.mark.parametrize("steps", GATHER_STEPS)
@pytest.mark.parametrize("shape", GATHER_SHAPES, ids=stage_shape_id)
def test_tile_gather_edge_shapes_on_cuda(shape, steps):
    """One step (straight from memory) and composed steps, at lanes 1 to
    4,096 and tiles of 1 to 4,096 rows; add wraps mod 2^32."""
    dev = _cuda()
    n_rows, lanes, axis, tile_rows = shape
    x, idx = gather_case(shape, seed=steps)
    x, idx = _t(x).to(dev), _t(idx).to(dev)
    before = tile_gather.launches
    got = tile_gather(x, idx, axis, tile_rows=tile_rows, steps=steps,
                      add=0xFFFFFFF0)
    assert tile_gather.launches == before + 1
    assert torch.equal(got, tile_gather_reference(
        x, idx, axis, tile_rows=tile_rows, steps=steps, add=0xFFFFFFF0))


@pytest.mark.gpu
@pytest.mark.parametrize("lead", [0, 1])
@pytest.mark.parametrize("n_idx", [1, 7, 8192])
@pytest.mark.parametrize("n_table", GATHER_TABLES)
def test_tile_gather_tables_on_cuda(n_table, n_idx, lead):
    """Tables of 1 and 4,096 words; indices and output 16-byte aligned
    (four words a thread where n allows) and 4 bytes past (one)."""
    dev = _cuda()
    rng = np.random.default_rng(n_table + n_idx)
    tab = _t(_u32(n_table, n_idx)).to(dev)
    buf = _t(rng.integers(0, n_table, n_idx + 1).astype(np.int32)).to(dev)
    idx = buf[lead: lead + n_idx]
    before = tile_gather.launches
    got = tile_gather(tab, idx, None)
    assert tile_gather.launches == before + 1
    assert torch.equal(got, tile_gather_reference(tab, idx, None))


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


def _rows(a):
    """numpy rows -> torch: int64 as it is, uint32 as int32 bits."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.dtype == np.int64 else a.view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("key_bytes", [8, 4])
@pytest.mark.parametrize("case", ROW_SORT_CASES)
def test_row_sort_kernel_edges_on_cuda(case, key_bytes):
    """int64 rows in signed order, words in unsigned order, at the edges of
    tests/kernel_edges.py (the widest row, width 1 and 2, a partly full
    last block, sentinels, the top bit)."""
    dev = _cuda()
    x = _rows(row_sort_case(case, key_bytes)).to(dev)
    before = row_sort.launches
    got = row_sort(x)
    assert row_sort.launches == before + 1
    assert torch.equal(got, row_sort_reference(x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, width, rows", [
    (torch.int64, 2048, 65), (torch.int64, 8192, 33), (torch.int64, 16384, 9),
    (torch.int32, 2048, 64), (torch.int32, 8192, 17), (torch.int32, 32768, 5),
    (torch.uint32, 64, 1000), (torch.int64, 128, 20000),
    (torch.int32, 256, 20000)])
def test_row_sort_kernel_engine_widths_on_cuda(dtype, width, rows):
    """The engine's and the sweep's widths, with as many rows as fill
    several blocks (at widths 128 and 256 enough to take full blocks, not
    one-warp ones); the built library reports the wrapper's limits."""
    dev = _cuda()
    lib = build_row_sort()
    assert lib.row_sort_max_width(8) == MAX_WIDTH[8]
    assert lib.row_sort_max_width(4) == MAX_WIDTH[4]
    gen = torch.Generator(device=dev).manual_seed(width + rows)
    lo, hi = (-(1 << 63), (1 << 63) - 1) if dtype == torch.int64 else (
        -(1 << 31), (1 << 31) - 1)
    x = torch.randint(lo, hi, (rows, width), dtype=torch.int64, device=dev,
                      generator=gen).to(dtype)
    assert torch.equal(row_sort(x), row_sort_reference(x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, width", [(torch.int64, 2), (torch.int64, 512),
                                          (torch.int32, 4), (torch.int32, 1)])
def test_row_sort_kernel_on_a_view_off_16_bytes(dtype, width):
    """A contiguous view one key past a 16-byte boundary takes the
    kernel's scalar loads and stores."""
    dev = _cuda()
    buf = torch.randint(-(1 << 30), 1 << 30, (300 * width + 1,),
                        dtype=torch.int64, device=dev).to(dtype)
    x = buf[1:].view(300, width)
    assert x.data_ptr() % 16
    assert torch.equal(row_sort(x), row_sort_reference(x))


@pytest.mark.gpu
def test_segment_copy_kernel_matches_plain_on_cuda():
    dev = _cuda()
    src = _t(_u32(5000, 6)).to(dev)
    rng = np.random.default_rng(7)
    for g, seg in ((1, 1), (64, 33), (300, 16)):
        in_off = rng.integers(0, 5000 - seg + 1, g)
        in_off[-1] = 5000 - seg
        plan = copy_plan(in_off, rng.permutation(g) * seg, seg, 5000,
                         g * seg, device=dev)
        assert torch.equal(segment_copy(src, plan),
                           segment_copy_reference(src, plan))
    plan = copy_plan([1, 2, 3], [0, 0, 0], 7, 5000, 7, device=dev)
    assert plan.overlap
    assert torch.equal(segment_copy(src, plan), src[3:10])


@pytest.mark.gpu
@pytest.mark.parametrize("name", OVERLAP_PLANS)
def test_segment_copy_overlap_plans_on_cuda(name):
    """Overlapping destinations: the card resolves each word's last
    writer, the same one on every run."""
    dev = _cuda()
    in_off, out_off, seg, n_in, n_out = overlap_plan(name)
    src = _t(_u32(n_in, 8)).to(dev)
    plan = copy_plan(in_off, out_off, seg, n_in, n_out, device=dev)
    before = segment_copy.launches
    got = segment_copy(src, plan)
    assert segment_copy.launches == before + 1
    assert torch.equal(got, segment_copy_reference(src, plan))
    assert torch.equal(segment_copy(src, plan), got)


@pytest.mark.gpu
@pytest.mark.parametrize("g", [6, 600])
@pytest.mark.parametrize("seg", [1, 3, 5, 1024, 1027])
@pytest.mark.parametrize("src_mod, dst_mod", [(0, 0), (1, 0), (0, 3),
                                              (2, 1), (3, 3)])
def test_segment_copy_alignments_on_cuda(src_mod, dst_mod, seg, g):
    """The 16-byte body's head, realignment and tail, on source and
    destination views 0 to 3 words past 16 bytes, with a few copies (128
    threads a copy) and with enough to fill the card (64)."""
    dev = _cuda()
    n = 8192
    buf = _t(_u32(n + 4, 9)).to(dev)
    src = buf[src_mod: src_mod + n]
    rng = np.random.default_rng(seg)
    in_off = rng.integers(0, n - seg + 1, g)
    in_off[0], in_off[-1] = 0, n - seg
    plan = copy_plan(in_off, rng.permutation(g) * seg, seg, n, g * seg,
                     device=dev)
    out = torch.zeros(g * seg + 4, dtype=torch.int32, device=dev)
    view = out[dst_mod: dst_mod + g * seg]
    assert src.data_ptr() % 16 == 4 * src_mod
    assert torch.equal(segment_copy(src, plan, view),
                       segment_copy_reference(src, plan))
    assert int(out[:dst_mod].abs().sum()) == 0  # nothing before the view


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("op", ["take2", "min", "min_add1", "add1", "copy"])
@pytest.mark.parametrize("shape", STAGE_SHAPES, ids=stage_shape_id)
def test_tile_stages_edge_shapes_on_cuda(shape, op, aligned):
    """Every path of the stage kernel (one pass, the 128-lane shuffle
    rows, warp lines, block lines) on each schedule of kernel_edges, on
    16-byte-aligned tensors and on views 4 bytes past."""
    dev = _cuda()
    n_rows, lanes, axis, tile_rows = shape
    n = n_rows * lanes
    lead = 0 if aligned else 1
    x = _t(_u32(n + 1, 10)).to(dev)[lead: lead + n].view(n_rows, lanes)
    lo = (_t(_u32(n + 1, 11)).to(dev)[lead: lead + n].view(n_rows, lanes)
          if op == "take2" else None)
    for name, shifts in SCHEDULES.items():
        sched = torch.tensor(shifts, dtype=torch.int32, device=dev)
        before = tile_stages.launches
        got = tile_stages(x, sched, op, axis, lo=lo, tile_rows=tile_rows)
        assert tile_stages.launches == before + 1
        ref = tile_stages_reference(x, sched, op, axis, lo=lo,
                                    tile_rows=tile_rows)
        if lo is None:
            got, ref = (got,), (ref,)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), name


def _wire(codes, lengths=None):
    words = pack2bit_rows(codes)
    if lengths is not None:
        words = np.concatenate([words, lengths[:, None]], axis=1)
    return _t(words.astype(np.uint32))


@pytest.mark.gpu
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("width, k", [(w, k) for w in WIRE_WIDTHS
                                      for k in WIRE_KS if k <= w])
def test_wire_keys_kernel_matches_plain_on_cuda(width, k, canonical):
    """Every slot, valid or not, with the length column and without, and
    into views of a flat buffer 16-byte aligned and 8 bytes past."""
    dev = _cuda()
    codes, lengths = wire_case(width, k, rows=300)
    m = width - k + 1
    for lens in (lengths, None):
        wire = _wire(codes, lens).to(dev)
        has = lens is not None
        want, want_valid = wire_keys_reference(wire, width, k, canonical,
                                               lengths=has)
        before = wire_keys.launches
        got, valid = wire_keys(wire, width, k, canonical, lengths=has)
        assert wire_keys.launches == before + 1
        assert torch.equal(got, want)
        assert (valid is None) == (not has)
        assert not has or torch.equal(valid, want_valid)
        for lead in (0, 1):
            keys = torch.full((300 * m + 2,), -7, dtype=torch.int64,
                              device=dev)
            view = keys[lead: lead + 300 * m].view(300, m)
            assert view.data_ptr() % 16 == 8 * lead
            wire_keys(wire, width, k, canonical, lengths=has, keys_out=view)
            assert torch.equal(view, want)
            assert int(keys[-1]) == -7 and (lead == 0 or int(keys[0]) == -7)


def _codes_at(codes, dev, offset):
    """codes as a [B, L] view ``offset`` bytes into a buffer on ``dev``."""
    buf = torch.zeros(codes.size + 32, dtype=torch.uint8, device=dev)
    view = buf[offset: offset + codes.size].view(codes.shape)
    view.copy_(torch.from_numpy(codes))
    assert view.is_contiguous() and view.data_ptr() % 16 == offset % 16
    return view


def _check_codes_keys(codes, lengths, k, canonical, dev,
                      offsets=(0, 1, 7, 15)):
    """The kernel equals the plain version in every slot, valid or not,
    on codes at byte offsets, int32 and int64 lengths, into fresh tensors
    and into views of flat buffers 16-byte aligned and 8 bytes past."""
    b, m = codes.shape[0], codes.shape[1] - k + 1
    for off in offsets:
        c = _codes_at(codes, dev, off)
        for lens in (lengths, lengths.astype(np.int64)):
            ln = torch.from_numpy(lens).to(dev)
            want, want_valid = codes_keys_reference(c, ln, k, canonical)
            before = codes_keys.launches
            got, valid = codes_keys(c, ln, k, canonical)
            assert codes_keys.launches == before + 1
            assert torch.equal(got, want) and torch.equal(valid, want_valid)
        for lead in (0, 1):
            keys = torch.full((b * m + 2,), -7, dtype=torch.int64, device=dev)
            ok = torch.zeros(b * m + 2, dtype=torch.bool, device=dev)
            view = keys[lead: lead + b * m].view(b, m)
            assert view.data_ptr() % 16 == 8 * lead
            codes_keys(c, ln, k, canonical, keys_out=view,
                       valid_out=ok[1: 1 + b * m].view(b, m))
            assert torch.equal(view, want)
            assert torch.equal(ok[1: 1 + b * m].view(b, m), want_valid)
            assert int(keys[-1]) == -7 and (lead == 0 or int(keys[0]) == -7)


@pytest.mark.gpu
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("width, k", [(w, k) for w in CODES_WIDTHS
                                      for k in CODES_KS if k <= w])
def test_codes_keys_kernel_matches_plain_on_cuda(width, k, canonical):
    dev = _cuda()
    codes, lengths = codes_case(width, k, rows=300)
    _check_codes_keys(codes, lengths, k, canonical, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [c[0] for c in CODES_SHAPES])
def test_codes_keys_block_edges_on_cuda(name):
    """One window a row (a block's most staged bytes), one long row over
    many blocks, rows cut by the block edges."""
    dev = _cuda()
    codes, lengths, k = codes_shape(name)
    _check_codes_keys(codes, lengths, k, True, dev, offsets=(0, 3))


@pytest.mark.gpu
@pytest.mark.parametrize("canonical", [False, True])
def test_codes_keys_codes_above_3_on_cuda(canonical):
    """A block holding codes above 3 takes the plain formula."""
    dev = _cuda()
    codes, lengths = wide_codes(150, 21, rows=300)
    _check_codes_keys(codes, lengths, 21, canonical, dev, offsets=(0, 5))


@pytest.mark.gpu
def test_codes_keys_refuses_other_dtypes_on_cuda():
    """Codes of another dtype raise TypeError and launch nothing; B = 0
    launches nothing."""
    dev = _cuda()
    codes, lengths = codes_case(150, 21)
    ln = torch.from_numpy(lengths).to(dev)
    before = codes_keys.launches
    for dtype in (torch.int64, torch.int32, torch.int8):
        with pytest.raises(TypeError, match="uint8"):
            codes_keys(torch.from_numpy(codes).to(dev, dtype), ln, 21, True)
    keys, valid = codes_keys(torch.zeros((0, 150), dtype=torch.uint8,
                                         device=dev), ln[:0], 21, True)
    assert keys.shape == valid.shape == (0, 130)
    assert codes_keys.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", STREAM_KS)
@pytest.mark.parametrize("n_reads, read_len", STREAM_CASES)
def test_stream_keys_kernel_matches_plain_on_cuda(n_reads, read_len, k,
                                                  canonical):
    """Every slot of the 16 phase rows, tail windows included, on words at
    a 16-byte boundary and 4 bytes past one."""
    dev = _cuda()
    words = pack2bit_rows(stream_case(n_reads, read_len)[None, :])[0]
    buf = torch.zeros(words.size + 1, dtype=torch.int32, device=dev)
    for w in (buf[:-1], buf[1:]):
        w.copy_(_t(words))
        want, want_valid = stream_keys_reference(w, k, canonical, read_len,
                                                 n_reads)
        before = stream_keys.launches
        got, valid = stream_keys(w, k, canonical, read_len, n_reads)
        assert stream_keys.launches == before + 1
        assert torch.equal(got, want) and torch.equal(valid, want_valid)


@pytest.mark.gpu
def test_stream_keys_refuses_on_cuda():
    dev = _cuda()
    words = _t(np.arange(64, dtype=np.uint32)).to(dev)
    before = stream_keys.launches
    with pytest.raises(TypeError, match="32-bit"):
        stream_keys(words.to(torch.int64), 21, True, 150, 1)
    keys, valid = stream_keys(words[:0], 21, True, 150, 0)
    assert keys.shape == valid.shape == (16, 0)
    assert stream_keys.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 5, 21, 32])
def test_halo_codes_on_cuda_matches_cpu(k):
    """``_extract_with_halo`` (one codes_keys launch a rank) on the card
    equals its CPU run (the plain version), keys and mask, on a one-rank
    mesh."""
    from kmer_tpu_torch.parallel.dist import _extract_with_halo
    from kmer_tpu_torch.parallel.mesh import make_mesh

    dev = _cuda()
    codes, lengths = codes_case(170, k, rows=64)
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    launches = codes_keys.launches
    got = _extract_with_halo(c.to(dev), ln.to(dev), k,
                             make_mesh((1, 1), device=dev), True)
    assert codes_keys.launches == launches + 1
    want = _extract_with_halo(c, ln, k, make_mesh((1, 1), device="cpu"),
                              True)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _fold_inputs(seed, n, k, pool):
    """Left-aligned k-mer keys drawn from ``pool`` values (a few all-t),
    and a validity mask."""
    rng = np.random.default_rng(seed)
    shift = 64 - 2 * k
    top = np.uint64(((1 << (2 * k)) - 1) << shift)
    vals = (rng.integers(0, 1 << 64, pool, dtype=np.uint64) & top).view(
        np.int64)
    vals[0] = -1 << shift  # the all-t k-mer (the sentinel's bits at k = 32)
    keys = torch.from_numpy(rng.choice(vals, n))
    valid = torch.from_numpy(rng.random(n) < 0.9)
    return keys, valid


@pytest.mark.gpu
@pytest.mark.parametrize("k", [5, 21, 31, 32])
def test_fold_on_cuda_equals_cpu(k):
    """fold_windows_into_wide on the card: every lane equals the CPU run,
    and the batch's count launches the segment-count kernel."""
    from kmer_tpu_torch.ops.wide import WideCounts, fold_windows_into_wide

    dev = _cuda()
    acc = {"cpu": WideCounts.empty(1 << 12, "cpu"),
           "cuda": WideCounts.empty(1 << 12, dev)}
    for step in range(3):
        keys, valid = _fold_inputs(100 * k + step, 50_000, k, 3000)
        before = segment_counts.launches
        acc["cuda"] = fold_windows_into_wide(acc["cuda"], keys.to(dev),
                                             valid.to(dev), k)
        assert segment_counts.launches == before + 1
        acc["cpu"] = fold_windows_into_wide(acc["cpu"], keys, valid, k)
    assert acc["cuda"].keys.is_cuda
    assert acc["cuda"].distinct() == acc["cpu"].distinct() > 0
    for got, want in zip(acc["cuda"].to_numpy(), acc["cpu"].to_numpy()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("budget", [None, 1 << 13])
def test_wide_accumulator_on_cuda_equals_cpu(budget):
    """WideAccumulator growth (and, with a budget, spills and the device
    K-way merge) on the card equals the CPU run."""
    from kmer_tpu_torch.ops.count import count_windows
    from kmer_tpu_torch.ops.wide import WideAccumulator

    dev = _cuda()
    accs = {d: WideAccumulator(capacity=64, max_capacity=budget, device=d)
            for d in ("cpu", dev)}
    for step in range(8):
        keys, valid = _fold_inputs(7 + step, 4000, 21, 1 << 14)
        for d, acc in accs.items():
            acc.add(count_windows(keys.to(d), valid.to(d), 21))
    cpu, gpu = accs["cpu"].result(), accs[dev].result()
    assert accs[dev].capacity == accs["cpu"].capacity
    assert accs[dev].n_spills == accs["cpu"].n_spills
    assert (accs[dev].n_spills > 0) == (budget is not None)
    for got, want in zip(gpu.trim().to_numpy(), cpu.trim().to_numpy()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_pipelined_fold_on_cuda_equals_cpu(tmp_path):
    """count_batches_pipelined with growth and spills to a directory: the
    card's table equals the CPU's, through the wire_keys and
    segment-count kernels."""
    from kmer_tpu_torch.pipeline import count_batches_pipelined

    dev = _cuda()
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 4, (256, 100), dtype=np.uint8),
                rng.integers(0, 101, 256).astype(np.int32))
               for _ in range(12)]
    results = {}
    for d in ("cpu", dev):
        before = segment_counts.launches, wire_keys.launches
        results[d] = count_batches_pipelined(
            iter(batches), 11, canonical=True, capacity=256,
            max_capacity=1 << 15, spill_dir=str(tmp_path / str(d)),
            device=d).trim()
        launched = (segment_counts.launches - before[0],
                    wire_keys.launches - before[1])
        assert launched == ((12, 12) if d == dev else (0, 0))
    for got, want in zip(results[dev].to_numpy(), results["cpu"].to_numpy()):
        np.testing.assert_array_equal(got, want)


# --- the trim to host on the card: the pinned ring, the slice and mask ----


def _parent_trim(t):
    """The trim before the pinned ring: a mask, the stacked int64 rows
    copied to pageable memory."""
    import dataclasses

    live = t.counts > 0
    idx = torch.nonzero(live).squeeze(1)
    rows = torch.stack([t.keys[idx], t.length[idx].to(torch.int64),
                        t.counts[idx].to(torch.int64)]).cpu()
    return dataclasses.replace(
        t, keys=rows[0], length=rows[1].to(torch.int32),
        counts=rows[2].to(t.counts.dtype), n_unique=int(rows.shape[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [4096, None])
def test_trim_through_the_ring_on_cuda_equals_cpu(monkeypatch, chunk):
    """A folded table on the card trims by slices through the pinned ring
    (many 4 KiB chunks, or the ring as built), and the same table with a
    stale ``n_unique`` by the mask; both equal the CPU table's lanes, in
    one unpinned host allocation, and the counters count each."""
    import dataclasses

    from kmer_tpu_torch.ops import landing
    from kmer_tpu_torch.ops.wide import WideCounts, fold_windows_into_wide

    dev = _cuda()
    if chunk is not None:
        monkeypatch.setattr(landing, "CHUNK_BYTES", chunk)
        monkeypatch.setattr(landing, "_ring", None)
    acc = {"cpu": WideCounts.empty(1 << 22, "cpu"),
           "cuda": WideCounts.empty(1 << 22, dev)}
    for step in range(3):
        keys, valid = _fold_inputs(500 + step, 1 << 20, 21, 1 << 22)
        for d in acc:
            on = acc[d].keys.device
            acc[d] = fold_windows_into_wide(acc[d], keys.to(on),
                                            valid.to(on), 21)
    want = acc["cpu"].trim().to_numpy()
    rows = want[0].size
    assert rows > (1 << 20) and acc["cuda"].n_unique == rows
    stale = dataclasses.replace(acc["cuda"], n_unique=rows // 2)
    for table, path in ((acc["cuda"], "slice"), (stale, "mask")):
        landing.zero_trims()
        got = table.trim()
        assert landing.trims() == {
            **dict.fromkeys(("slice", "mask", "host"), 0), path: 1,
            "ring_bytes": 20 * rows}
        cols = (got.keys, got.length, got.counts)
        assert all(c.device.type == "cpu" and not c.is_pinned()
                   for c in cols)
        assert len({c.untyped_storage().data_ptr() for c in cols}) == 1
        assert got.n_unique == rows
        for g, w in zip(got.to_numpy(), want):
            assert g.dtype == w.dtype and g.flags.c_contiguous
            np.testing.assert_array_equal(g, w)
    ring = landing.ring()
    assert ring.is_pinned()
    assert ring.shape == (landing.SLOTS, chunk or landing.CHUNK_BYTES)


@pytest.mark.gpu
@pytest.mark.parametrize("budget", [[], ["--max-slots", str(1 << 22)]])
def test_count_save_on_cuda_is_the_parent_trims_file(tmp_path, capsys,
                                                     budget):
    """``count --save`` on the card writes, byte for byte, the file that
    the trim before the ring gives, and the CPU's; the printed tables
    match."""
    from kmer_tpu_torch.cli import main
    from kmer_tpu_torch.parallel.streaming import save_wide
    from kmer_tpu_torch.pipeline import count_file

    _cuda()
    rng = np.random.default_rng(9)
    fq = str(tmp_path / "reads.fastq")
    with open(fq, "wb") as f:
        for i in range(4000):
            seq = np.frombuffer(b"ACGT", np.uint8)[
                rng.integers(0, 4, 150)].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * 150))
    files, printed = {}, {}
    for dev in ("cuda", "cpu"):
        files[dev] = str(tmp_path / f"{dev}.npz")
        assert main(["count", "--input", fq, "-k", "21", "--canonical",
                     "--device", dev, "--save", files[dev], *budget]) == 0
        printed[dev] = capsys.readouterr().out
    assert printed["cuda"] == printed["cpu"] and printed["cuda"].count(
        "\n") > 1000
    result = count_file(fq, "fastq", 21, canonical=True, device="cuda",
                        max_capacity=int(budget[1]) if budget else None)
    parent = str(tmp_path / "parent.npz")
    save_wide(_parent_trim(result), parent, {"k": 21, "canonical": True})
    with open(parent, "rb") as f:
        want = f.read()
    for dev in ("cuda", "cpu"):
        with open(files[dev], "rb") as f:
            assert f.read() == want, dev


# --- the SQL surface on the card: every result equals the CPU's ----------


def _sql_rows(n, seed):
    from kmer_tpu_torch.io.datagen import generate_test_rows

    return generate_test_rows(n, seed=seed) + [
        ("ACGT", "acga", "angry"), ("A", "", "n"), ("TT", "t" * 32, "u")]


@pytest.mark.gpu
@pytest.mark.parametrize("k, canonical", [(4, False), (21, True), (32, False)])
def test_count_dna_on_cuda_launches_the_kernel(k, canonical):
    from kmer_tpu_torch.ops.count import count_dna

    dev = _cuda()
    dna = "".join("ACGT"[c] for c in np.random.default_rng(k).integers(
        0, 4, 5000)) + "T" * 40
    before = segment_counts.launches, codes_keys.launches
    got = count_dna(dna, k, canonical, device=dev)
    assert (segment_counts.launches, codes_keys.launches) == (
        before[0] + 1, before[1] + 1)
    want = count_dna(dna, k, canonical, device="cpu")
    for g, w in zip(got.trim().to_numpy(), want.trim().to_numpy()):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("indexed", [False, True])
def test_kmer_table_on_cuda_equals_cpu(indexed):
    from kmer_tpu_torch.api import KmerTable

    dev = _cuda()
    rows = _sql_rows(3000, 7)
    tables = [KmerTable.from_rows(rows, device=d) for d in (dev, "cpu")]
    for t in tables:
        if indexed:
            t.create_index()
        t.insert_rows(_sql_rows(40, 8))
        t.delete_where_kmer_eq("acga")
    answers = []
    for t in tables:
        answers.append((
            [t.where_eq(q).tolist() for q in ("acga", "", "t" * 32, "a")],
            [t.where_prefix(q).tolist() for q in ("", "a", "ac", "t" * 32)],
            [t.where_pattern(q).tolist() for q in ("angry", "n" * 8, "u")],
            t.group_by_kmer().to_dict(), t.distinct_kmers()))
    assert answers[0] == answers[1]
    assert tables[0]._jcol().key.is_cuda


@pytest.mark.gpu
def test_device_indexes_on_cuda_equal_cpu():
    from kmer_tpu_torch.index import DeviceHashIndex, DeviceIndex
    from kmer_tpu_torch.ops.predicates import qkmer_mask_vector
    from kmer_tpu_torch.packed import KmerColumn, PackedKmers

    dev = _cuda()
    kmers = [r[1].lower() for r in _sql_rows(5000, 11)]
    host = PackedKmers.from_strings(kmers)
    q = PackedKmers.from_strings(kmers[::13] + ["", "t" * 32, "gggg", "t"])
    pats = ["nnnn", "angr", "acga", "n" * 21, "t" * 32]
    masks = torch.from_numpy(np.stack(
        [qkmer_mask_vector(p)[0] for p in pats if len(p) == 4]
    ).astype(np.int64))
    out = []
    for d in (dev, "cpu"):
        idx = DeviceIndex.build(KmerColumn.from_packed(host, d))
        qc = KmerColumn.from_packed(q, d)
        fence = idx.build_fence(bits=12)
        rows, hit, trunc = idx.pattern_hits(masks.to(d), qlen=4, cap=64)
        h = DeviceHashIndex.build(host, device=d)
        out.append([t.cpu() for t in (
            *idx.eq_ranges(qc.key, qc.length),
            *idx.eq_ranges(qc.key, qc.length, fence),
            *idx.prefix_ranges(qc.key, qc.length, fence),
            rows, hit, trunc, h.table, *h.lookup_eq(qc.key, qc.length))]
            + [r.tolist() for r in idx.search_pattern_batch(pats, cap=8)])
    for g, w in zip(*out):
        assert (torch.equal(g, w) if isinstance(g, torch.Tensor) else g == w)


@pytest.mark.gpu
def test_v_hash_on_cuda_is_bit_equal():
    from kmer_tpu_torch.ops.predicates import _hash_finalize_np, v_hash
    from kmer_tpu_torch.packed import KmerColumn, key_from_hi_lo

    dev = _cuda()
    hi, lo = _u32(100_000, 1), _u32(100_000, 2)
    ln = np.random.default_rng(3).integers(0, 33, 100_000).astype(np.int32)
    col = KmerColumn(key=torch.from_numpy(key_from_hi_lo(hi, lo)).to(dev),
                     length=torch.from_numpy(ln).to(dev))
    np.testing.assert_array_equal(v_hash(col).cpu().numpy(),
                                  _hash_finalize_np(hi, lo, ln).view(np.int32))


@pytest.mark.gpu
def test_parity_on_cuda(capsys):
    from kmer_tpu_torch.parity import run_parity, run_scale_parity

    _cuda()
    before = segment_counts.launches
    assert run_parity(device="cuda")
    assert segment_counts.launches > before
    assert run_scale_parity(n_rows=3000, n_probes=12, device="cuda")
    assert "FAIL" not in capsys.readouterr().out


@pytest.mark.gpu
def test_cli_dna_column_count_on_cuda_equals_cpu(tmp_path, capsys):
    from kmer_tpu_torch.cli import main
    from kmer_tpu_torch.io.datagen import rows_to_csv

    _cuda()
    path = str(tmp_path / "rows.csv")
    rows_to_csv(_sql_rows(2000, 21), path)
    out = []
    for dev in ("cuda", "cpu"):
        before = (wire_keys.launches, segment_counts.launches)
        assert main(["count", "--input", path, "-k", "8",
                     "--from-dna-column", "--device", dev]) == 0
        if dev == "cuda":
            assert wire_keys.launches > before[0]
            assert segment_counts.launches > before[1]
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and out[0].count("\n") > 100


@pytest.mark.gpu
def test_query_and_pattern_bench_on_cuda():
    from kmer_tpu_torch.bench import run_pattern_bench, run_query_bench

    _cuda()
    q = run_query_bench(n_keys=1 << 16, n_queries=1 << 14, device="cuda")
    p = run_pattern_bench(n_keys=1 << 16, n_queries=1 << 12, device="cuda")
    assert q["detail"]["device"] == p["detail"]["device"] != "cpu"
    assert q["value"] > 0 and p["detail"]["prefix12_hits"] >= 1 << 12


def _launches():
    return wire_keys.launches, segment_counts.launches


def _same_trimmed(got, want):
    g, w = got.trim(), want.trim()
    for a, b in zip(g.to_numpy(), w.to_numpy()):
        np.testing.assert_array_equal(a, b)
    assert got.distinct() == want.distinct()


@pytest.mark.gpu
@pytest.mark.parametrize("k, kernel_launches", [(6, 0), (21, 1)])
def test_kmer_counter_on_cuda_equals_cpu(k, kernel_launches):
    """Both routes make their keys in one codes_keys launch a step; the
    dense route (k = 6) launches no segment-count kernel, the sort route
    (k = 21) launches it once a step."""
    from kmer_tpu_torch.config import EngineConfig
    from kmer_tpu_torch.models import KmerCounter
    from kmer_tpu_torch.ops.extract import simulate_reads

    dev = _cuda()
    reads = simulate_reads(2000, 150, seed=k)
    reads[0] = 3
    lengths = np.random.default_rng(k).integers(0, 151, 2000).astype(
        np.int32)
    cfg = EngineConfig(k=k, canonical=True)
    before = _launches(), codes_keys.launches
    counter = KmerCounter(cfg, device=dev)
    got = counter.step(reads, lengths)
    assert got.keys.is_cuda
    assert _launches() == (before[0][0], before[0][1] + kernel_launches)
    assert codes_keys.launches == before[1] + 1
    counter.check_exact()
    _same_trimmed(got, KmerCounter(cfg, device="cpu").step(reads, lengths))


@pytest.mark.gpu
def test_graft_entry_on_cuda_equals_cpu():
    from kmer_tpu_torch.graft_entry import entry

    _cuda()
    fn, args = entry("cuda")
    before = segment_counts.launches, codes_keys.launches
    got = fn(*args)
    assert (segment_counts.launches, codes_keys.launches) == (
        before[0] + 1, before[1] + 1)
    cpu_fn, cpu_args = entry("cpu")
    _same_trimmed(got, cpu_fn(*cpu_args))


@pytest.mark.gpu
@pytest.mark.parametrize("k, chunk", [(31, 1 << 17), (9, 4096), (32, 1 << 20)])
def test_long_sequence_on_cuda_equals_cpu(k, chunk, tmp_path):
    """The fast path: one wire_keys launch a chunk, one segment count; the
    resumable path: one of each a chunk."""
    from kmer_tpu_torch.streaming import (
        count_long_sequence, iter_chunks_with_overlap)
    from kmer_tpu_torch.utils.checkpoint import ResumableCount

    dev = _cuda()
    codes = np.random.default_rng(k).integers(0, 4, 300_000, np.uint8)
    codes[1000:1100] = 3
    n_chunks = len(list(iter_chunks_with_overlap(codes, chunk, k)))
    before = _launches()
    got = count_long_sequence(codes, k, True, chunk=chunk, device=dev)
    assert _launches() == (before[0] + n_chunks, before[1] + 1)
    want = count_long_sequence(codes, k, True, chunk=chunk, device="cpu")
    _same_trimmed(got, want)
    rc = ResumableCount(str(tmp_path / "ck.npz"), device=dev)
    before = _launches()
    resumed = count_long_sequence(codes, k, True, chunk=chunk, resumable=rc,
                                  device=dev)
    assert _launches() == (before[0] + n_chunks, before[1] + n_chunks)
    assert resumed.to_dict() == want.to_dict()


@pytest.mark.gpu
@pytest.mark.parametrize("budget", [None, 1 << 16])
def test_read_stream_on_cuda_equals_cpu(budget, tmp_path):
    """Six batches of 33,280 slots; a 2^16-slot budget forces spills."""
    from kmer_tpu_torch.streaming import count_read_stream

    dev = _cuda()
    rng = np.random.default_rng(5)
    batches = [(rng.integers(0, 4, (256, 150), np.uint8),
                rng.integers(0, 151, 256).astype(np.int32))
               for _ in range(6)]
    kw = dict(capacity=1 << 10, max_capacity=budget,
              spill_dir=str(tmp_path / "runs") if budget else None)
    before = _launches()
    got = count_read_stream(iter(batches), 21, True, **kw, device=dev)
    assert _launches() == (before[0] + 6, before[1] + 6)
    want = count_read_stream(iter(batches), 21, True, capacity=1 << 10,
                             device="cpu")
    _same_trimmed(got, want)
    if budget:
        assert os.listdir(tmp_path / "runs")


@pytest.mark.gpu
def test_serve_on_cuda_equals_cpu(tmp_path, monkeypatch, capsys):
    """``serve --device cuda`` over stdin answers as ``--device cpu``;
    the table's column and GROUP BY run on the card."""
    import io

    from kmer_tpu_torch.cli import main
    from kmer_tpu_torch.io.datagen import rows_to_csv

    _cuda()
    path = str(tmp_path / "rows.csv")
    rows_to_csv(_sql_rows(3000, 31), path)
    script = ("EQ acga\nPREFIX ac\nPATTERN angry\nCOUNT\nDISTINCT\nGROUP 5\n"
              "INSERT acgt,acga,nn\nDELETE tttt\nDELETEDNA acgt\nEQ acga\n"
              "GROUP 5\nEQ not-dna\nQUIT\n")
    out = []
    for dev in ("cuda", "cpu"):
        for flags in ([], ["--no-index"]):
            monkeypatch.setattr("sys.stdin", io.StringIO(script))
            assert main(["serve", "--input", path, "--device", dev,
                         *flags]) == 0
            out.append(capsys.readouterr().out)
    assert out[0] == out[1] == out[2] == out[3]
    assert out[0].count("\n") == 13


# --- the multi-device port's collectives and shards on the card -------------


def _one_rank_group(backend):
    """A process group of this process alone on ``backend``."""
    import datetime

    import torch.distributed as dist

    from kmer_tpu_torch.parallel.launch import free_port

    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_comm_on_a_one_rank_group(backend):
    """Each collective of ``parallel.comm`` runs on CUDA tensors in a
    group of one rank (nccl: on the card; gloo: staged through the host
    where gloo does not take CUDA tensors) and returns its input's
    values, on the card."""
    import torch.distributed as dist

    from kmer_tpu_torch.parallel import comm
    from kmer_tpu_torch.parallel.mesh import make_mesh

    dev = _cuda()
    _one_rank_group(backend)
    try:
        mesh = make_mesh((1, 1), device=dev)
        x = torch.arange(6, dtype=torch.int64, device=dev).reshape(3, 2)
        for got in (comm.all_gather_tiled(x, mesh),
                    comm.all_gather_tiled(x, mesh, "data"),
                    comm.all_to_all_slabs(x[None], mesh)[0],
                    comm.all_reduce_sum(x, mesh), comm.ring_shift(x, mesh)):
            assert got.device.type == "cuda" and torch.equal(got, x)
        if backend == "gloo":
            assert "all_to_all_single" in comm.STAGED
            assert not comm.STAGED & comm.GLOO_CUDA
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [5, 21, 32])
def test_halo_wire_on_cuda_matches_cpu(k):
    """``_wire_keys_with_halo`` (one wire_keys launch a rank) on the card
    equals its CPU run (the plain version), keys and mask, on a one-rank
    mesh; and the sharded count step there equals the one-device count."""
    from kmer_tpu_torch.ops.count import count_kmers
    from kmer_tpu_torch.parallel.dist import (
        _wire_keys_with_halo, make_sharded_count_step)
    from kmer_tpu_torch.parallel.mesh import make_mesh

    dev = _cuda()
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (64, 160), dtype=np.uint8)
    lengths = rng.integers(0, 161, 64).astype(np.int32)
    words = _t(pack2bit_rows(codes))
    lens = torch.from_numpy(lengths)
    launches = wire_keys.launches
    got = _wire_keys_with_halo(words.to(dev), lens.to(dev), k,
                               make_mesh((1, 1), device=dev), True)
    assert wire_keys.launches == launches + 1
    want = _wire_keys_with_halo(words, lens, k,
                                make_mesh((1, 1), device="cpu"), True)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    mesh = make_mesh((1, 1), device=dev)
    for merge in ("gather", "partition"):
        out = make_sharded_count_step(mesh, k, True, merge)(codes, lengths)
        table = out[0] if merge == "partition" else out
        one = count_kmers(torch.from_numpy(codes).to(dev),
                          torch.from_numpy(lengths).to(dev), k, True)
        t, o = table.trim(), one.trim()
        assert torch.equal(t.keys, o.keys) and torch.equal(t.counts, o.counts)


# --- the phase probes and the matrix-unit rates on the card -----------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(set(PHASE_KERNELS) - {"matmul"}))
def test_phase_probes_on_cuda_equal_cpu(name, tmp_path):
    """Each phase family at its small size on the card: every probe
    correct, the count path's kernels launched where the family counts,
    and every result table equal to the family's run on the CPU."""
    from kmer_tpu_torch.probes import FAMILIES

    dev = _cuda()
    runs = {}
    for d in (dev, torch.device("cpu")):
        work = tmp_path / d.type
        work.mkdir()
        before = launches()
        runs[d.type] = list(FAMILIES[name].run(d, small=True,
                                               workdir=str(work)))
        launched = {n for n, a in launches().items() if a > before[n]}
        assert all(r.correct for r in runs[d.type]), d
        assert launched == (set(PHASE_KERNELS[name]) if d.type == "cuda"
                            else set())
    assert [r.card for r in runs["cuda"]] != [None] * len(runs["cuda"])
    assert ([r.tables for r in runs["cuda"]]
            == [r.tables for r in runs["cpu"]])


@pytest.mark.gpu
def test_matmul_rates_on_cuda():
    """(d) exact, (h) within its tolerance, each with its own time in a
    CUDA graph beside its bound."""
    from kmer_tpu_torch.probes import matmul

    dev = _cuda()
    d, h = matmul.run(dev, small=True)
    assert d.correct and d.max_abs_err == 0
    assert h.correct
    for rec in (d, h):
        assert rec.graph_ms > 0 and rec.bound_ms > 0
