"""numpy models of the index arithmetic of the kernels
``csrc/segment_copy.cu``, ``csrc/tile_stages.cu``, ``csrc/tile_gather.cu``
``csrc/wire_keys.cu`` and ``csrc/codes_keys.cu``, held against their
plain PyTorch versions (which ``tests/test_torch_probes.py``,
``tests/test_torch_wire_keys.py`` and ``tests/test_torch_codes_keys.py``
hold against the Pallas bodies and kmer_tpu).  A CUDA kernel cannot run
here; these models repeat its indices step by step (ownership of
overlapping copies, the 16-byte body's split and realignment, the composed
shift and gathers, the warp layouts' partner reads, the wire's three-word
windows and their 16-byte pairs, the word stream's phase rows, the codes'
staged byte range and its packing), so a wrong index shows here before the
card.
Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from kmer_tpu_torch.kernels.segment_copy import (
    copy_plan, segment_copy, segment_copy_reference)
from kmer_tpu_torch.kernels.tile_gather import tile_gather_reference
from kmer_tpu_torch.kernels.tile_stages import (
    GROUP, tile_stages, tile_stages_reference)
from kmer_tpu_torch.kernels.codes_keys import codes_keys_reference
from kmer_tpu_torch.kernels.wire_keys import (
    stream_keys_reference, wire_keys_reference)
from kernel_edges import (
    CODES_BLOCK, CODES_KS, CODES_SHAPES, CODES_WIDTHS, GATHER_SHAPES,
    GATHER_TABLES, OVERLAP_PLANS, SCHEDULES, STAGE_SHAPES, STREAM_BLOCK,
    STREAM_CASES, STREAM_KS, WIRE_KS, WIRE_WIDTHS, codes_case, codes_shape,
    gather_case, overlap_plan, stage_shape_id, stream_case, wide_codes,
    wire_case)


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


# --- tile_gather: one step from memory, more steps composed on chip ------


def _pow2_at_least(n):
    p = 1
    while p < n:
        p *= 2
    return p


def gather_geometry(n_rows, lanes, axis, rows, sms=132):
    """tile_gather_launch's groups for more than one step: (gr, gc,
    strips, blocks, threads, registers a thread)."""
    want = 2 * sms
    if axis == 1:
        gr = max(1, 1024 // lanes)
        while gr > 1 and -(-n_rows // gr) < want:
            gr //= 2
        gc, strips, blocks, words = lanes, 1, -(-n_rows // gr), gr * lanes
    else:
        gr = 1
        gc = min(lanes, max(1, min(4096 // rows, max(8, 1024 // rows))))
        while gc > 1 and (n_rows // rows) * -(-lanes // gc) < want:
            gc //= 2
        strips = -(-lanes // gc)
        blocks, words = (n_rows // rows) * strips, rows * gc
    threads = min(256, -(-words // 32) * 32)
    per = _pow2_at_least(-(-words // threads))
    return gr, gc, strips, blocks, threads, per


def gather_group(blk, n_rows, rows, lanes, axis, gr, gc, strips):
    """group_of: (row0, col0, nr, nc) of block ``blk``."""
    if axis == 1:
        row0 = blk * gr
        return row0, 0, min(gr, n_rows - row0), lanes
    tile, strip = divmod(blk, strips)
    return tile * rows, strip * gc, rows, min(gc, lanes - strip * gc)


def composed_model(x, idx, axis, rows, steps, add, sms=132):
    """gather_composed: per group, each word's source inside the group in
    registers (word e of the group at slice position e), idx^steps by
    squarings and products through the published slice, then one gather
    of the group's words; returns (out, gathers a word)."""
    n_rows, lanes = x.shape
    gr, gc, strips, blocks, threads, per = gather_geometry(
        n_rows, lanes, axis, rows, sms)
    assert threads % 32 == 0 and per <= 16 and threads * per <= 4096
    xf, idf = x.reshape(-1), idx.reshape(-1)
    out = np.zeros(x.size, np.uint64)
    written = np.zeros(x.size, np.int64)
    for blk in range(blocks):
        row0, col0, nr, nc = gather_group(blk, n_rows, rows, lanes, axis, gr,
                                          gc, strips)
        e = np.arange(threads * per)
        live = e < nr * nc
        r, c = np.where(live, e // nc, 0), np.where(live, e % nc, 0)
        at = (row0 + r) * lanes + col0 + c
        i = np.where(live, idf[at], 0)
        assert ((0 <= i) & (i < (nc if axis == 1 else nr)))[live].all()
        pw = np.where(live, r * nc + i if axis == 1 else i * nc + c, 0)
        res, s, have, gathers = np.zeros_like(pw), steps, False, 0
        while True:
            bit, s = s & 1, s >> 1
            product = bit and have
            if bit and not have:
                res, have = pw.copy(), True
            if not product and s == 0:
                break
            published = pw.copy()  # one barrier
            if product:
                res, gathers = published[res], gathers + 1
            if s:
                pw, gathers = published[pw], gathers + 1
            if s == 0:
                break
        val = np.where(live, xf[at], 0).astype(np.uint64)
        out[at[live]] = (val[res] + np.uint64(steps * add))[live] & 0xFFFFFFFF
        written[at[live]] += 1
    assert (written == 1).all()
    return out.astype(np.uint32).reshape(x.shape), gathers + 1


def direct_model(x, idx, axis, rows, add):
    """gather_direct: four consecutive words a thread where n (and lanes,
    for the tile forms) are multiples of 4, one otherwise; each word's
    source from its row (axis 1), its tile's row i (axis 0) or the table
    (axis None), computed from the thread's first word's row."""
    xf, idf = x.reshape(-1), idx.reshape(-1)
    n = idf.size
    lanes = 1 if axis is None else x.shape[1]
    w = 4 if n % 4 == 0 and (axis is None or lanes % 4 == 0) else 1
    bound = x.size if axis is None else (lanes if axis == 1 else rows)
    out = np.zeros(n, np.uint64)
    for h in range(w):
        e0 = np.arange(0, n, w)
        e = e0 + h
        row = np.zeros_like(e0) if axis is None else e0 // lanes
        c = e - row * lanes
        i = idf[e]
        assert ((0 <= i) & (i < bound)).all()
        if axis is None:
            src = i
        elif axis == 1:
            src = e - c + i
        else:
            src = (row - row % rows + i) * lanes + c
        out[e] = (xf[src].astype(np.uint64) + add) & 0xFFFFFFFF
    return out.astype(np.uint32).reshape(idx.shape)


def _gather_ref(x, idx, axis, rows, steps, add):
    return _np(tile_gather_reference(_t(x), _t(idx), axis, tile_rows=rows,
                                     steps=steps, add=add))


@pytest.mark.parametrize("steps", [3, 128])
@pytest.mark.parametrize("shape", GATHER_SHAPES, ids=stage_shape_id)
def test_composed_gather_model_matches_reference(shape, steps):
    """On a full card and on one SM (other group sizes), at the edges of
    kernel_edges; add wraps mod 2^32."""
    n_rows, lanes, axis, tile_rows = shape
    rows = tile_rows or n_rows
    x, idx = gather_case(shape, seed=steps)
    add = 0xFFFFFFF0
    want = _gather_ref(x, idx, axis, rows, steps, add)
    for sms in (132, 1):
        got, _ = composed_model(x, idx, axis, rows, steps, add, sms)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", GATHER_SHAPES, ids=stage_shape_id)
def test_direct_gather_model_matches_reference(shape):
    n_rows, lanes, axis, tile_rows = shape
    rows = tile_rows or n_rows
    x, idx = gather_case(shape, seed=1)
    np.testing.assert_array_equal(direct_model(x, idx, axis, rows, 5),
                                  _gather_ref(x, idx, axis, rows, 1, 5))


@pytest.mark.parametrize("n_idx", [1, 7, 8192])
@pytest.mark.parametrize("n_table", GATHER_TABLES)
def test_table_gather_model_matches_reference(n_table, n_idx):
    rng = np.random.default_rng(n_table + n_idx)
    tab = rng.integers(0, 1 << 32, n_table, dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, n_table, n_idx).astype(np.int32)
    np.testing.assert_array_equal(direct_model(tab, idx, None, 1, 0),
                                  _gather_ref(tab, idx, None, 1, 1, 0))


@pytest.mark.parametrize("steps", [1, 2, 3, 5, 7, 64, 127, 128, 129])
def test_composed_gathers_are_the_issued_ops(steps):
    """The kernel's gathers a word, bit_length - 1 squarings, popcount - 1
    products and the gather of the words, are the rate probe's issued
    operations (one a word a gather), so the bound counts what it runs."""
    from kmer_tpu_torch.probes import rates

    x, idx = gather_case((16, 128, 1, None), seed=steps)
    _, gathers = composed_model(x, idx, 1, 16, steps, 1)
    assert rates.issued_ops("gather", x.size, steps) == x.size * gathers
    assert gathers <= 2 * steps.bit_length()


def test_gather_groups_fill_the_card_at_the_probe_shapes():
    """The amplified probes (128 tiles [512, 128]) get eight rows a group
    on axis 1 and eight columns (32-byte row pieces) on axis 0; the
    probes' [64, 128] tiles get one row, or one column, a group."""
    tiles = 128 * 512
    assert gather_geometry(tiles, 128, 1, 512)[:4] == (8, 128, 1, 8192)
    assert gather_geometry(tiles, 128, 0, 512)[1:4] == (8, 16, 2048)
    assert gather_geometry(64, 128, 1, 64)[0] == 1
    assert gather_geometry(64, 128, 0, 64)[1:4] == (1, 128, 128)


# --- wire_keys: the window arithmetic and the pair layout ----------------

_LOW_BITS = np.uint64(0x5555555555555555)


def brev64(x):
    """__brevll on uint64 values."""
    bits = np.unpackbits(np.ascontiguousarray(x, ">u8").view(np.uint8))
    rev = np.packbits(bits.reshape(-1, 64)[:, ::-1], axis=1)
    return rev.view(">u8").reshape(-1).astype(np.uint64)


def window_key_model(staged, base, nw, i, k, canonical):
    """window_key: words w, w + 1, w + 2 of the staged row at ``base``
    (zero past its nw base words), shifted by 2 (i % 16), masked to 2k
    bits; the reverse complement is ~key, brev, a swap of each pair's two
    bits and << 64 - 2k; the canonical key is the unsigned minimum."""
    w = i >> 4
    sh = (2 * (i & 15)).astype(np.uint64)

    def word(j):
        return np.where(j < nw, staged[base + np.minimum(j, nw - 1)],
                        0).astype(np.uint64)

    w0, w1, w2 = word(w), word(w + 1), word(w + 2)
    mask = np.uint64(((1 << 64) - 1) ^ ((1 << (64 - 2 * k)) - 1))
    key = ((((w0 << np.uint64(32)) | w1) << sh)
           | ((w2 << sh) >> np.uint64(32))) & mask
    return canonical_model(key, k) if canonical else key


def canonical_model(key, k):
    """canonical_key: the reverse complement is ~key, brev, a swap of each
    pair's two bits and << 64 - 2k; the canonical key is the unsigned
    minimum."""
    rc = brev64(~key)
    one = np.uint64(1)
    rc = ((rc >> one) & _LOW_BITS) | ((rc & _LOW_BITS) << one)
    if k < 32:
        rc = rc << np.uint64(64 - 2 * k)
    return np.minimum(key, rc)


def wire_rows_per_block(m, ncols):
    """wire_keys_launch: rows a block stages (at least one, ~4,096 slots,
    at most 8,192 words)."""
    return max(1, min(4096 // m, 8192 // ncols))


def wire_keys_model(wire, width, k, canonical, lengths, lead):
    """wire_keys_kernel over every block: the staged rows, slot pairs
    aligned to 16 bytes of an output ``lead`` slots past such a boundary,
    each pair's (row, window) from one division and a step; returns (keys
    uint64, valid or None), asserting every slot is written once."""
    n_rows, ncols = wire.shape
    nw, m = -(-width // 16), width - k + 1
    rows = wire_rows_per_block(m, ncols)
    flat = wire.reshape(-1)
    keys = np.zeros(n_rows * m, np.uint64)
    valid = np.zeros(n_rows * m, bool)
    writes = np.zeros(n_rows * m, np.int64)
    for row0 in range(0, n_rows, rows):
        nr = min(rows, n_rows - row0)
        staged = flat[row0 * ncols: (row0 + nr) * ncols]
        e0, n = row0 * m, nr * m
        q0 = (e0 + lead) >> 1
        g = 2 * (q0 + np.arange(((e0 + n - 1 + lead) >> 1) - q0 + 1)) - lead
        ll = g - e0
        assert ll.min() >= -1
        r = np.where(ll < 0, 0, ll // m)
        i = np.where(ll < 0, 0, ll - r * m)
        slots = [(ll, r, i)]
        i2 = np.where(ll >= 0, i + 1, i)
        wrap = (ll >= 0) & (i2 == m)
        slots.append((ll + 1, r + wrap, np.where(wrap, 0, i2)))
        first, second = ll >= 0, ll + 1 < n
        assert ((g[first & second] + lead) % 2 == 0).all()  # 16-byte stores
        for li, rr, ii in slots:
            ok = (li >= 0) & (li < n)
            rr, ii = rr[ok], ii[ok]
            np.testing.assert_array_equal(rr * m + ii, li[ok])
            at = e0 + li[ok]
            keys[at] = window_key_model(staged, rr * ncols, nw, ii, k,
                                        canonical)
            if lengths:
                valid[at] = ii <= staged[rr * ncols + nw].astype(
                    np.int64) - k
            writes[at] += 1
    assert (writes == 1).all()
    return keys.reshape(n_rows, m), valid.reshape(n_rows, m) if lengths \
        else None


def _wire_words(codes, lengths):
    from kmer_tpu_torch.native import pack2bit_rows

    words = pack2bit_rows(codes)
    if lengths is not None:
        words = np.concatenate([words, lengths[:, None]], axis=1)
    return np.ascontiguousarray(words, np.uint32)


WIRE_CASES = [(w, k) for w in WIRE_WIDTHS for k in WIRE_KS if k <= w]


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("width, k", WIRE_CASES)
def test_wire_keys_model_matches_reference(width, k, canonical):
    """Every slot, valid or not, on outputs 16-byte aligned and 8 bytes
    past, with and without the length column."""
    codes, lengths = wire_case(width, k, rows=40)
    for lens in (lengths, None):
        wire = _wire_words(codes, lens)
        want, want_valid = wire_keys_reference(
            _t(wire), width, k, canonical, lengths=lens is not None)
        for lead in (0, 1):
            got, valid = wire_keys_model(wire, width, k, canonical,
                                         lens is not None, lead)
            np.testing.assert_array_equal(got.view(np.int64), want.numpy())
            if lens is not None:
                np.testing.assert_array_equal(valid, want_valid.numpy())


@pytest.mark.parametrize("width, k", [(160, 21), (16, 16), (65520, 31),
                                      (32, 1)])
def test_wire_keys_blocks_stay_in_shared_memory(width, k):
    """A block stages at most 8,192 words (32 KB) and at least one row;
    the main path's batch (width 160, k = 21: 140 slots a row) gets 29 rows
    a block."""
    ncols = -(-width // 16) + 1
    rows = wire_rows_per_block(width - k + 1, ncols)
    assert rows >= 1 and rows * ncols <= 8192
    if (width, k) == (160, 21):
        assert rows == 29


def test_reverse_complement_by_brev_is_revcomp_packed():
    """~key, brev, the pair swap and the shift give revcomp_packed."""
    from kmer_tpu_torch.ops.extract import revcomp_packed

    rng = np.random.default_rng(17)
    for k in WIRE_KS:
        key = rng.integers(0, 1 << 64, 500, dtype=np.uint64)
        key &= np.uint64(((1 << 64) - 1) ^ ((1 << (64 - 2 * k)) - 1))
        rc = brev64(~key)
        rc = ((rc >> np.uint64(1)) & _LOW_BITS) | (
            (rc & _LOW_BITS) << np.uint64(1))
        if k < 32:
            rc = rc << np.uint64(64 - 2 * k)
        want = revcomp_packed(torch.from_numpy(key.view(np.int64).copy()), k)
        np.testing.assert_array_equal(rc.view(np.int64), want.numpy())


# --- codes_keys: the staged byte range, its packing and the pair layout --


def pack4_model(x):
    """pack4: the low two bits of 4 bytes of a little-endian word, byte 0
    in the top two of 8 bits."""
    t = x & np.uint32(0x03030303)
    return ((t << np.uint32(6)) | (t >> np.uint32(4)) | (t >> np.uint32(14))
            | (t >> np.uint32(24))) & np.uint32(0xFF)


def codes_smem_words(L, k):
    """codes_keys_launch: the staged words a block may need."""
    m = L - k + 1
    spanned = (m - 1 + CODES_BLOCK - 1) // m
    return ((spanned + 1) * (k - 1) + CODES_BLOCK + 30) // 16


def codes_keys_model(buf, off, n_rows, L, k, canonical, lengths, lead):
    """codes_keys_kernel over every block, on codes at ``buf[off:]`` (buf
    16-byte aligned at 0), into an output ``lead`` slots past a 16-byte
    boundary: each block's byte range, staged from the 16-byte boundary
    at or before it in 16-byte loads (byte loads at its ends) packed to
    words, the wide flag, each pair's (row, window) from one division and
    a step.  Returns (keys uint64, valid), asserting every slot is written
    once and no block stages more than the launch allows or reads outside
    the codes."""
    m = L - k + 1
    n_slots = n_rows * m
    keys = np.zeros(n_slots, np.uint64)
    valid = np.zeros(n_slots, bool)
    writes = np.zeros(n_slots, np.int64)
    smem = codes_smem_words(L, k)
    chunks = np.zeros(-(-(off + n_rows * L) // 16) * 16, np.uint8)
    chunks[: buf.size] = buf[: chunks.size]
    for e0 in range(0, n_slots, CODES_BLOCK):
        n = min(CODES_BLOCK, n_slots - e0)
        r0, i0 = divmod(e0, m)
        r1, i1 = divmod(e0 + n - 1, m)
        lo, hi = off + r0 * L + i0, off + r1 * L + i1 + k
        assert off <= lo < hi <= off + n_rows * L
        a0 = lo & ~15
        nws = (hi - a0 + 15) // 16
        assert nws <= smem
        a = a0 + 16 * np.arange(nws)
        whole = (a >= lo) & (a + 16 <= hi)
        raw = chunks[a[:, None] + np.arange(16)]  # the 16 bytes at a
        inside = (a[:, None] + np.arange(16) >= lo) & (
            a[:, None] + np.arange(16) < hi)
        raw = np.where(whole[:, None] | inside, raw, 0).astype(np.uint8)
        v = np.ascontiguousarray(raw).view("<u4").reshape(nws, 4)
        loaded = (pack4_model(v[:, 0]) << np.uint32(24)
                  | pack4_model(v[:, 1]) << np.uint32(16)
                  | pack4_model(v[:, 2]) << np.uint32(8)
                  | pack4_model(v[:, 3]))
        by_byte = np.zeros(nws, np.uint32)
        for j in range(16):
            by_byte |= (raw[:, j].astype(np.uint32) & np.uint32(3)) << \
                np.uint32(30 - 2 * j)
        staged = np.where(whole, loaded, by_byte)
        wide = bool((np.bitwise_or.reduce(raw.reshape(-1)) & 0xFC) != 0)
        skew = lo - a0
        q0 = (e0 + lead) >> 1
        g = 2 * (q0 + np.arange(((e0 + n - 1 + lead) >> 1) - q0 + 1)) - lead
        ll = g - e0
        assert ll.min() >= -1
        dr = np.where(ll < 0, 0, (i0 + ll) // m)
        i = np.where(ll < 0, i0 - 1, i0 + ll - dr * m)
        slots = [(ll, dr, i)]
        i2 = i + 1
        wrap = i2 == m
        slots.append((ll + 1, dr + wrap, np.where(wrap, 0, i2)))
        first, second = ll >= 0, ll + 1 < n
        assert ((g[first & second] + lead) % 2 == 0).all()  # 16-byte stores
        for li, dd, ii in slots:
            ok = (li >= 0) & (li < n)
            dd, ii = dd[ok], ii[ok]
            at = e0 + li[ok]
            np.testing.assert_array_equal((r0 + dd) * m + ii, at)
            if not wide:
                keys[at] = window_key_model(staged, 0, nws,
                                            dd * L + ii - i0 + skew, k,
                                            canonical)
            else:
                start = off + (r0 + dd) * L + ii
                key = np.zeros(at.size, np.uint64)
                for j in range(k):
                    key |= buf[start + j].astype(np.uint64) << np.uint64(
                        62 - 2 * j)
                keys[at] = canonical_model(key, k) if canonical else key
            valid[at] = ii <= lengths[r0 + dd].astype(np.int64) - k
            writes[at] += 1
    assert (writes == 1).all()
    return keys.reshape(n_rows, m), valid.reshape(n_rows, m)


def _codes_model_check(codes, lengths, k, canonical, offsets=(0, 5, 15)):
    """The model at byte offsets of the codes and both output leads
    against the plain version."""
    want, want_valid = codes_keys_reference(
        torch.from_numpy(codes), torch.from_numpy(lengths), k, canonical)
    n_rows, L = codes.shape
    for off in offsets:
        buf = np.zeros(off + codes.size + 16, np.uint8)
        buf[off: off + codes.size] = codes.reshape(-1)
        for lead in (0, 1):
            got, valid = codes_keys_model(buf, off, n_rows, L, k, canonical,
                                          lengths, lead)
            np.testing.assert_array_equal(got.view(np.int64), want.numpy())
            np.testing.assert_array_equal(valid, want_valid.numpy())


CODES_CASES = [(w, k) for w in CODES_WIDTHS for k in CODES_KS if k <= w]


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("width, k", CODES_CASES)
def test_codes_keys_model_matches_reference(width, k, canonical):
    """Every slot, valid or not, with the codes 0, 5 and 15 bytes past a
    16-byte boundary and outputs 16-byte aligned and 8 bytes past."""
    codes, lengths = codes_case(width, k, rows=40)
    _codes_model_check(codes, lengths, k, canonical)


@pytest.mark.parametrize("name", [c[0] for c in CODES_SHAPES])
def test_codes_keys_model_block_edges(name):
    """One window a row (a block's most staged bytes), one long row over
    many blocks, rows cut by the block edges."""
    codes, lengths, k = codes_shape(name)
    _codes_model_check(codes, lengths, k, True, offsets=(3,))


@pytest.mark.parametrize("canonical", [False, True])
def test_codes_keys_model_codes_above_3(canonical):
    """A block holding a code above 3 takes the plain formula; the
    others stay on the staged words; both equal the plain version."""
    codes, lengths = wide_codes(150, 21, rows=80)
    _codes_model_check(codes, lengths, 21, canonical, offsets=(1,))


@pytest.mark.parametrize("width, k", [(150, 21), (170, 21), (32, 32),
                                      (1, 1), (161, 2), ((1 << 20), 31)])
def test_codes_keys_blocks_stay_in_shared_memory(width, k):
    """A block stages at most 32 KB plus two words (m = 1, k = 32: 4,096
    rows of 32 bases), under the 48 KB a launch takes without an opt-in;
    the sustained batch's halo'd rows (170 bases, k = 21) take 1.2 KB."""
    words = codes_smem_words(width, k)
    assert 4 * words <= 32 * 1024 + 8
    if (width, k) == (170, 21):
        assert 4 * words <= 1300


# --- stream_keys: the word stream's phase rows ----------------------------


def stream_keys_model(words, k, canonical, read_len, n_reads, lead):
    """stream_keys_kernel over every block: 512 words and the two after
    them staged, each of the 16 phase rows' slots of the block in pairs
    aligned to 16 bytes of an output ``lead`` slots past such a boundary,
    the position's offset in its read from one 32-bit remainder and a
    step of 16.  Returns (keys uint64 [16, nw], valid), asserting every
    slot is written once."""
    nw = words.size
    keys = np.zeros(16 * nw, np.uint64)
    valid = np.zeros(16 * nw, bool)
    writes = np.zeros(16 * nw, np.int64)
    last = n_reads * read_len - k
    assert 16 * (nw + 1) < 1 << 32  # the narrow remainder
    for w0 in range(0, nw, STREAM_BLOCK):
        n = min(STREAM_BLOCK, nw - w0)
        nws = min(STREAM_BLOCK + 2, nw - w0)
        staged = words[w0: w0 + nws]
        for r in range(16):
            e0 = r * nw + w0
            q0 = (e0 + lead) >> 1
            g = 2 * (q0 + np.arange(((e0 + n - 1 + lead) >> 1) - q0 + 1)) \
                - lead
            ll = g - e0
            pos = 16 * (w0 + ll) + r
            rem = np.where(ll >= 0, pos, pos + 16) % read_len
            for h in (0, 1):
                ok = (ll + h >= 0) & (ll + h < n)
                if h == 1:
                    step = ll >= 0
                    rem = np.where(step, rem + 16, rem)
                    rem = np.where(rem >= read_len, rem % read_len, rem)
                at = e0 + ll[ok] + h
                keys[at] = window_key_model(staged, 0, nws,
                                            16 * (ll[ok] + h) + r, k,
                                            canonical)
                valid[at] = (rem[ok] <= read_len - k) & (
                    pos[ok] + 16 * h <= last)
                writes[at] += 1
    assert (writes == 1).all()
    return keys.reshape(16, nw), valid.reshape(16, nw)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", STREAM_KS)
@pytest.mark.parametrize("n_reads, read_len", STREAM_CASES)
def test_stream_keys_model_matches_reference(n_reads, read_len, k,
                                             canonical):
    """Every slot of the 16 phase rows, tail windows included, on outputs
    16-byte aligned and 8 bytes past."""
    from kmer_tpu_torch.native import pack2bit_rows

    words = pack2bit_rows(stream_case(n_reads, read_len)[None, :])[0]
    want, want_valid = stream_keys_reference(_t(words), k, canonical,
                                             read_len, n_reads)
    for lead in (0, 1):
        got, valid = stream_keys_model(words, k, canonical, read_len,
                                       n_reads, lead)
        np.testing.assert_array_equal(got.view(np.int64), want.numpy())
        np.testing.assert_array_equal(valid, want_valid.numpy())
