"""numpy models of the index arithmetic of the probe kernels
``csrc/segment_copy.cu`` and ``csrc/tile_stages.cu``, held against their
plain PyTorch versions (which ``tests/test_torch_probes.py`` holds against
the Pallas bodies).  A CUDA kernel cannot run here; these models repeat its
indices step by step (ownership of overlapping copies, the 16-byte body's
split and realignment, the composed shift, the warp layouts' partner
reads), so a wrong index shows here before the card.  Every comparison is
exact.
"""

import numpy as np
import pytest
import torch

from kmer_tpu_torch.kernels.segment_copy import (
    copy_plan, segment_copy, segment_copy_reference)
from kmer_tpu_torch.kernels.tile_stages import (
    GROUP, tile_stages, tile_stages_reference)
from kernel_edges import (
    OVERLAP_PLANS, SCHEDULES, STAGE_SHAPES, overlap_plan, stage_shape_id)


def _u32(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _np(t):
    return t.contiguous().numpy().view(np.uint32)


def _c_mod(s, n):
    """C's ``s % n`` for n > 0, made non-negative (``mod_len``)."""
    d = np.fmod(np.asarray(s, np.int64), n)
    return np.where(d < 0, d + n, d)


# --- segment_copy: the last writer of overlapping copies -----------------


def owner_model(out_off, seg, n_out):
    """claim_words: owner[w] starts at -1, and each copy, the last one
    first, raises it to its index over its words."""
    owner = np.full(n_out, -1, np.int64)
    for g in range(len(out_off) - 1, -1, -1):
        w = slice(out_off[g], out_off[g] + seg)
        owner[w] = np.maximum(owner[w], g)
    return owner


def owned_copy_model(src, in_off, out_off, seg, n_out):
    """copy_owned: every copy stores the words it owns (zeros elsewhere,
    as the wrapper's default destination)."""
    owner = owner_model(out_off, seg, n_out)
    out = np.zeros(n_out, src.dtype)
    w = np.flatnonzero(owner >= 0)
    g = owner[w]
    out[w] = src[in_off[g] + w - out_off[g]]
    return out


@pytest.mark.parametrize("name", OVERLAP_PLANS)
def test_owner_map_model_matches_reference(name):
    in_off, out_off, seg, n_in, n_out = overlap_plan(name)
    plan = copy_plan(in_off, out_off, seg, n_in, n_out)
    assert plan.overlap == (name != "g1")
    src = _u32(n_in, 3)
    want = _np(segment_copy_reference(_t(src), plan))
    np.testing.assert_array_equal(
        owned_copy_model(src, in_off, out_off, seg, n_out), want)
    np.testing.assert_array_equal(_np(segment_copy(_t(src), plan)), want)


def test_owner_map_is_order_free():
    """A max does not depend on the order the atomics land in: any order of
    the claims gives the same owners."""
    in_off, out_off, seg, _, n_out = overlap_plan("random")
    want = owner_model(out_off, seg, n_out)
    rng = np.random.default_rng(5)
    for _ in range(3):
        owner = np.full(n_out, -1, np.int64)
        for g in rng.permutation(len(out_off)):
            w = slice(out_off[g], out_off[g] + seg)
            owner[w] = np.maximum(owner[w], g)
        np.testing.assert_array_equal(owner, want)


def vector_copy_model(src, s0, d0, seg):
    """copy_segment on word addresses (the arrays start 16-byte aligned):
    a scalar head up to the destination's 16-byte boundary, 16-byte body
    stores, each from the two aligned source vectors that hold its words,
    and a scalar tail.  Returns the copied words and asserts that every
    aligned source vector read shares its 16-byte line with a word of the
    segment."""
    head = min(seg, (-d0) & 3)
    body = (seg - head) >> 2
    tail = head + 4 * body
    assert 0 <= seg - tail <= 3 and (body == 0 or (d0 + head) % 4 == 0)
    padded = np.concatenate([np.zeros(4, src.dtype), src,
                             np.zeros(8, src.dtype)])  # words -4 ...
    out = np.zeros(seg, src.dtype)
    out[:head] = src[s0: s0 + head]
    out[tail:] = src[s0 + tail: s0 + seg]
    sb = s0 + head
    r = sb & 3
    a0 = sb - r
    lines = set(range(s0 // 4, (s0 + seg - 1) // 4 + 1))
    for j in range(body):
        a = a0 + 4 * j
        reads = [a] if r == 0 else [a, a + 4]
        assert all(x // 4 in lines for x in reads)
        pair = np.concatenate([padded[x + 4: x + 8] for x in reads])
        out[head + 4 * j: head + 4 * j + 4] = pair[r: r + 4]
    return out


@pytest.mark.parametrize("seg", [1, 2, 3, 4, 5, 7, 8, 9, 1024, 1027])
@pytest.mark.parametrize("dst_mod", [0, 1, 2, 3])
def test_vector_body_model_copies_every_alignment(seg, dst_mod):
    src = _u32(4096, seg)
    for src_mod in range(4):
        s0 = 100 + src_mod
        got = vector_copy_model(src, s0, 200 + dst_mod, seg)
        np.testing.assert_array_equal(got, src[s0: s0 + seg])
    # copies that touch the source's first and last words
    np.testing.assert_array_equal(vector_copy_model(src, 0, dst_mod, seg),
                                  src[:seg])
    np.testing.assert_array_equal(
        vector_copy_model(src, 4096 - seg, dst_mod, seg), src[-seg:])


def test_segment_copy_refuses_out_sharing_the_source():
    """copy g + 1 would read what copy g wrote: the kernel, running every
    copy at once, cannot give that in-order result, so the wrapper
    refuses it (a view of the source too)."""
    src = _t(_u32(64, 1))
    plan = copy_plan([0, 8], [8, 16], 8, 64, 64)
    with pytest.raises(ValueError, match="shares storage"):
        segment_copy(src, plan, out=src)
    buf = _t(_u32(128, 2))
    with pytest.raises(ValueError, match="shares storage"):
        segment_copy(buf[:64], plan, out=buf[64:])
    out = torch.zeros(64, dtype=torch.int32)
    assert torch.equal(segment_copy(src, plan, out=out),
                       segment_copy_reference(src, plan))


# --- tile_stages: the composed families ---------------------------------


def composed_shift_model(shifts, length):
    """total_shift: lane i % 32 sums its terms (each reduced mod len
    first), mod len; the 32 partial sums add up, mod len."""
    m = _c_mod(shifts, length)
    acc = np.zeros(32, np.int64)
    np.add.at(acc, np.arange(m.size) % 32, m)
    return int((acc % length).sum() % length)


def roll_pass_model(x, d, rows, axis):
    """roll_pass's source index for every output word, with its 16-byte
    branch (lanes a multiple of 4: axis 0 and d % 4 == 0 read an aligned
    vector, else four words that wrap at the row's end)."""
    n_rows, lanes = x.shape
    vec = lanes % 4 == 0
    w = 4 if vec else 1
    out = np.empty_like(x)
    for row in range(n_rows):
        for c in range(0, lanes, w):
            if axis == 0:
                r = row % rows
                from_row = row - r + (r - d if r >= d else r - d + rows)
                from_c = c
            else:
                from_row = row
                from_c = c - d if c >= d else c - d + lanes
            if not vec or axis == 0 or d % 4 == 0:
                assert from_c + w <= lanes
                out[row, c: c + w] = x[from_row, from_c: from_c + w]
            else:
                for k in range(4):
                    f = from_c + k
                    out[row, c + k] = x[from_row, f if f < lanes else f - lanes]
    return out


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("shape", [(8, 128, 1, None), (8, 33, 1, None),
                                   (16, 12, 0, 8), (6, 5, 0, 3)],
                         ids=stage_shape_id)
def test_composed_roll_model_matches_reference(shape, sched):
    n_rows, lanes, axis, tile_rows = shape
    rows = tile_rows or n_rows
    shifts = SCHEDULES[sched]
    d = composed_shift_model(shifts, lanes if axis == 1 else rows)
    x = _u32((n_rows, lanes), 7)
    sched_t = torch.tensor(shifts, dtype=torch.int32)
    want = _np(tile_stages_reference(_t(x), sched_t, "copy", axis,
                                     tile_rows=tile_rows))
    np.testing.assert_array_equal(roll_pass_model(x, d, rows, axis), want)
    # the plain int32 sum of the near-2^31 schedule overflows; the model's
    # terms do not
    assert 0 <= d < (lanes if axis == 1 else rows)


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_composed_add_matches_reference(sched):
    """n stages of +1 are one add of n, mod 2^32 (add_pass)."""
    x = _u32((8, 128), 9)
    x[0, :5] = 0xFFFFFFFF
    shifts = torch.tensor(SCHEDULES[sched], dtype=torch.int32)
    want = _np(tile_stages_reference(_t(x), shifts, "add1", 1))
    np.testing.assert_array_equal(x + np.uint32(len(SCHEDULES[sched])), want)


def test_composed_shift_on_a_long_schedule():
    """Every lane of the warp's sum holds terms: 1,000 shifts near +-2^31."""
    rng = np.random.default_rng(11)
    shifts = rng.integers(-2**31, 2**31, 1000)
    for length in (1, 3, 128, 4096):
        want = int(np.sum(_c_mod(shifts, length)) % length)
        assert composed_shift_model(shifts, length) == want
        assert want == int(np.sum(shifts.astype(object)) % length)


# --- tile_stages: the dependent families --------------------------------


def schedule_model(shifts, length):
    """Schedule: lane i of the warp holds stage 32c + i's shift mod len
    for chunk c, the next chunk loads 32 stages ahead, and stage s reads
    lane s % 32 of the current chunk."""
    shifts = np.asarray(shifts, np.int64)

    def load(first):
        i = first + np.arange(32)
        return np.where(i < shifts.size, _c_mod(
            shifts[np.minimum(i, max(shifts.size - 1, 0))] if shifts.size
            else np.zeros(32, np.int64), length), 0)

    cur, nxt = load(0), load(32)
    got = []
    for s in range(shifts.size):
        if s and s % 32 == 0:
            cur, nxt = nxt, load(s + 32)
        got.append(int(cur[s % 32]))
    return got


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 64, 65, 256, 300])
def test_schedule_chunks_give_every_stage_its_shift(n):
    shifts = np.random.default_rng(n).integers(-2**31, 2**31, n)
    for length in (1, 7, 128, 1024):
        assert schedule_model(shifts, length) == [
            int(v) for v in _c_mod(shifts, length)]


def _combine(op, h, lo, ph, pl):
    if op == "take2":
        take = (ph < h) | ((ph == h) & (pl < lo))
        return np.where(take, ph, h), np.where(take, pl, lo)
    if op == "min":
        return np.minimum(ph, h), lo
    if op == "copy":
        return ph, lo
    return np.minimum(ph, h) + np.uint32(1), lo  # min_add1, wraps


def rows128_source(lane, k, shift):
    """row_stage: the (lane, register) that word k of ``lane`` reads its
    partner from, for a stage of ``shift`` on a 128-lane row."""
    e = (128 - _c_mod(shift, 128)) & 127
    q, r = e >> 2, e & 3
    from_lane = np.where(k + r < 4, (lane + q) & 31, (lane + q + 1) & 31)
    return from_lane, (k + r) & 3


@pytest.mark.parametrize("shift", [0, 1, 2, 3, 4, 5, 64, 127, 128, 129, -1,
                                   -3, -128, -200, 2**31 - 1, -2**31])
def test_rows128_source_map_is_np_roll(shift):
    """Word k of lane t holds row position 4t + k; the shuffle it reads
    holds np.roll's partner, position (4t + k - shift) mod 128."""
    lane, k = np.meshgrid(np.arange(32), np.arange(4), indexing="ij")
    from_lane, reg = rows128_source(lane, k, shift)
    pos = np.arange(128)
    np.testing.assert_array_equal((4 * from_lane + reg).reshape(-1),
                                  np.roll(pos, shift)[pos])


def rows128_model(h, lo, shifts, op):
    """rows128: one warp a row, [rows, 32 lanes, 4 registers], each stage
    a shuffle read by rows128_source and a combine."""
    n_rows = h.shape[0]
    hh, ll = h.reshape(n_rows, 32, 4), lo.reshape(n_rows, 32, 4)
    lane, k = np.meshgrid(np.arange(32), np.arange(4), indexing="ij")
    for s in shifts:
        fl, reg = rows128_source(lane, k, s)
        hh, ll = _combine(op, hh, ll, hh[:, fl, reg], ll[:, fl, reg])
    return hh.reshape(n_rows, 128), ll.reshape(n_rows, 128)


def line_layouts(length):
    """The (warps a line, registers a thread) pairs the dispatch may pick
    for a line of ``length`` words: one warp with the fewest registers
    that hold it; eight warps for lines of 257 to 1,024 words when lines
    are too few to give each SM four warps; a block of 32 warps above
    1,024 words."""
    if length > 1024:
        return [(32, GROUP // 1024)]
    p = 1
    while 32 * p < length:
        p *= 2
    return [(1, p)] + ([(8, 2 if length <= 512 else 4)] if length > 256
                       else [])


def line_model(h, lo, shifts, op, axis, rows, warps, per):
    """line_stages with ``warps`` warps a line and ``per`` registers a
    thread: word p = j * 32 warps + t of line ``line`` sits at
    x[base + p * step]; every register is published to a shared slice
    and each reads position q = p - d (mod len) there."""
    n_rows, lanes = h.shape
    length = lanes if axis == 1 else rows
    n_lines = n_rows if axis == 1 else (n_rows // rows) * lanes
    kt = 32 * warps
    assert kt * per >= length > kt * per // 2 or per == 1
    line = np.arange(n_lines)[:, None]
    if axis == 1:
        base, step = line * lanes, 1
    else:
        tile = line // lanes
        base, step = tile * rows * lanes + (line - tile * lanes), lanes
    t, j = np.meshgrid(np.arange(kt), np.arange(per), indexing="ij")
    p = (j * kt + t).reshape(-1)  # every register, past len too
    live = p < length
    at = base + np.where(live, p, 0)[None, :] * step
    hf, lf = h.reshape(-1), lo.reshape(-1)
    hv, lv = hf[at], lf[at]  # [lines, registers]; past len: any words
    slot = np.empty(kt * per, np.int64)
    slot[p] = np.arange(p.size)  # slice position -> the register there
    for s in shifts:
        d = int(_c_mod(s, length))
        q = np.where(p >= d, p - d, p - d + length)
        assert q.max() < kt * per
        hv, lv = _combine(op, hv, lv, hv[:, slot[q]], lv[:, slot[q]])
    out_h, out_l = hf.copy(), lf.copy()
    out_h[at[:, live]], out_l[at[:, live]] = hv[:, live], lv[:, live]
    return out_h.reshape(h.shape), out_l.reshape(lo.shape)


def _stage_case(shape, sched, op, seed=13):
    n_rows, lanes, axis, tile_rows = shape
    h, lo = _u32((n_rows, lanes), seed), _u32((n_rows, lanes), seed + 1)
    h[:, ::3] = 7  # ties on h, so lo decides some take2 compares
    lo[:, ::5] = 7
    h[0, :2] = 0xFFFFFFFF  # + 1 wraps
    shifts = SCHEDULES[sched]
    got = tile_stages_reference(_t(h), torch.tensor(shifts, dtype=torch.int32),
                                op, axis, lo=_t(lo) if op == "take2" else None,
                                tile_rows=tile_rows)
    want = tuple(_np(g) for g in got) if op == "take2" else (_np(got),)
    return h, lo, shifts, want


@pytest.mark.parametrize("op", ["take2", "min", "min_add1", "copy"])
@pytest.mark.parametrize("sched", ["empty", "mixed", "near_2_31"])
def test_rows128_model_matches_reference(sched, op):
    """copy takes one shuffle stage of the composed shift."""
    h, lo, shifts, want = _stage_case((8, 128, 1, None), sched, op)
    if op == "copy":
        shifts = [composed_shift_model(shifts, 128)]
    got = rows128_model(h, lo, shifts, op)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("op", ["take2", "min", "min_add1"])
@pytest.mark.parametrize("shape", STAGE_SHAPES, ids=stage_shape_id)
def test_line_model_matches_reference(shape, op):
    n_rows, lanes, axis, tile_rows = shape
    h, lo, shifts, want = _stage_case(shape, "mixed", op)
    rows = tile_rows or n_rows
    for warps, per in line_layouts(lanes if axis == 1 else rows):
        got = line_model(h, lo, shifts, op, axis, rows, warps, per)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("rows", [512, 1024])
def test_line_source_map_on_tile_columns_is_np_roll(rows):
    """Axis 0 at 512 and 1,024 tile rows: one warp a column, word p in
    register p // 32 of lane p % 32; the (lane, register) a word reads is
    np.roll's partner row, for shifts of every size and sign."""
    warps, per = line_layouts(rows)[0]
    assert warps == 1 and 32 * per == rows
    lane, j = np.meshgrid(np.arange(32), np.arange(per), indexing="ij")
    p = j * 32 + lane
    pos = np.arange(rows)
    for shift in (0, 1, 31, 32, 33, rows - 1, rows, -1, -rows - 5, 2**31 - 1,
                  -2**31):
        d = int(_c_mod(shift, rows))
        q = np.where(p >= d, p - d, p - d + rows)
        from_lane, from_reg = q % 32, q // 32
        np.testing.assert_array_equal(
            (from_reg * 32 + from_lane).reshape(-1),
            np.roll(pos, shift)[p.reshape(-1)])
