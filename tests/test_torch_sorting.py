"""The row sort (``kernels/row_sort.py``) and the sort-floor probes
(``probes/sorting.py``) on the CPU.

* ``row_sort_reference`` against ``np.sort`` over the edge cases of
  ``tests/kernel_edges.py``: int64 rows in signed order, 32-bit words in
  unsigned order;
* a numpy model of ``csrc/row_sort.cu``'s algorithm (each thread's keys
  sorted by the bitonic network, then merge-path levels) at small block
  sizes, so its logic is held against ``np.sort`` here; the kernel itself
  runs on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``);
* the widths and dtypes the wrapper refuses;
* the probe family at its small size, and the TPU sorts it stands for:
  ``lax.sort`` of (hi, lo16) with two keys, or one key and a payload, in
  the order of the one int64 key; r3b's per-row counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu_torch.kernels.row_sort import (
    MAX_WIDTH, row_sort, row_sort_reference)
from kmer_tpu_torch.probes import sorting
from kernel_edges import (
    ROW_SORT_CASES, ROW_SORT_TILE, ROW_SORT_WARP_TILE, row_sort_case)


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _np(t, dtype):
    return t.contiguous().numpy().view(dtype)


@pytest.mark.parametrize("key_bytes", [8, 4])
@pytest.mark.parametrize("case", ROW_SORT_CASES)
def test_row_sort_reference_equals_np_sort(case, key_bytes):
    x = row_sort_case(case, key_bytes)
    want = np.sort(x, axis=1)
    np.testing.assert_array_equal(_np(row_sort_reference(_t(x)), x.dtype),
                                  want)
    np.testing.assert_array_equal(_np(row_sort(_t(x)), x.dtype), want)


def test_edge_cases_reach_the_widths_and_tiles():
    for key_bytes, tile in ROW_SORT_TILE.items():
        assert MAX_WIDTH[key_bytes] == tile
        assert row_sort_case("widest", key_bytes).shape[1] == tile
        warp = ROW_SORT_WARP_TILE[key_bytes]
        for case, t in (("partial_tile", tile), ("partial_warp_tile", warp)):
            rows, width = row_sort_case(case, key_bytes).shape
            assert (rows * width) % t and rows * width > t
        # a full block's case is wider than a warp's tile
        assert row_sort_case("partial_tile", key_bytes).shape[1] > warp
    x = row_sort_case("top_bit_mixed", 8)
    assert (x < 0).any() and (x >= 0).any()


# --- a numpy model of csrc/row_sort.cu's algorithm ------------------------


def _sort_registers(v, width):
    """The kernel's in-register network: every stage sorts its blocks
    ascending (mirror step, then half-cleaners), up to min(width, E)."""
    e = len(v)
    k = 2
    while k <= e and k <= width:
        for i in range(e):
            m = i ^ (k - 1)
            if m > i and v[m] < v[i]:
                v[i], v[m] = v[m], v[i]
        j = k >> 2
        while j > 0:
            for i in range(e):
                m = i ^ j
                if m > i and v[m] < v[i]:
                    v[i], v[m] = v[m], v[i]
            j >>= 1
        k <<= 1
    return v


def _merge_level(s, first, run, e):
    """One merge-path level for the thread whose outputs start at
    ``first``, as ``merge_level`` in the CUDA source."""
    g = first & ~(2 * run - 1)
    diag, b0 = first - g, g + run
    lo, hi = max(0, diag - run), min(diag, run)
    while lo < hi:
        mid = (lo + hi) >> 1
        if s[g + mid] <= s[b0 + diag - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    ia, ib = lo, diag - lo
    out = []
    for _ in range(e):
        take_a = ib >= run or (ia < run and s[g + ia] <= s[b0 + ib])
        if take_a:
            out.append(s[g + ia])
            ia += 1
        else:
            out.append(s[b0 + ib])
            ib += 1
    return out


def kernel_model(x, threads, per_thread):
    """The rows of ``x`` sorted as a grid of blocks of ``threads`` threads
    of ``per_thread`` keys each sorts them."""
    n_rows, width = x.shape
    tile = threads * per_thread
    assert width <= tile and tile % width == 0
    flat = x.reshape(-1)
    top = np.iinfo(x.dtype).max
    out = np.empty_like(flat)
    for base in range(0, flat.size, tile):
        live = min(tile, flat.size - base)
        s = np.full(tile, top, x.dtype)
        s[:live] = flat[base: base + live]
        v = [_sort_registers(list(s[t * per_thread: (t + 1) * per_thread]),
                             width) for t in range(threads)]
        run = per_thread
        while run < width:
            s = np.array(sum(v, []), x.dtype)
            v = [_merge_level(s, t * per_thread, run, per_thread)
                 for t in range(threads)]
            run <<= 1
        out[base: base + live] = np.array(sum(v, []), x.dtype)[:live]
    return out.reshape(x.shape)


@pytest.mark.parametrize("key_bytes", [8, 4])
@pytest.mark.parametrize("threads, per_thread, width", [
    (t, e, w) for t, e in ((8, 4), (4, 16), (16, 2))
    for w in (1, 2, 4, 8, 16, 32) if w <= t * e])
def test_kernel_model_sorts_every_row(width, key_bytes, threads, per_thread):
    rng = np.random.default_rng(width * key_bytes + threads)
    dtype = np.int64 if key_bytes == 8 else np.uint32
    rows = (3 * threads * per_thread) // width + 1  # a partly full tile
    x = rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, (rows, width),
                     dtype=dtype, endpoint=True)
    x[::3] = x[::3] % 5  # repeats
    np.testing.assert_array_equal(kernel_model(x, threads, per_thread),
                                  np.sort(x, axis=1))


@pytest.mark.parametrize("case", ["all_equal", "all_flipped_sentinel",
                                  "top_heavy", "top_bit_mixed", "descending",
                                  "width_2", "few_values"])
def test_kernel_model_on_edge_rows(case):
    for key_bytes in (8, 4):
        x = row_sort_case(case, key_bytes)[:, :64]
        x = x[: max(1, 256 // x.shape[1])]
        np.testing.assert_array_equal(kernel_model(x, 8, 8),
                                      np.sort(x, axis=1))


@pytest.mark.parametrize("x, err", [
    (torch.zeros(4, 96, dtype=torch.int64), ValueError),
    (torch.zeros(4, 3, dtype=torch.int32), ValueError),
    (torch.zeros(2, 32768, dtype=torch.int64), ValueError),
    (torch.zeros(1, 65536, dtype=torch.int32), ValueError),
    (torch.zeros(4, 0, dtype=torch.int64), ValueError),
    (torch.zeros(2, 2, 8, dtype=torch.int64), ValueError),
    (torch.zeros(4, 16, dtype=torch.int64)[:, ::2], ValueError),
    (torch.zeros(4, 16, dtype=torch.int16), TypeError),
])
def test_wrong_rows_raise(x, err):
    with pytest.raises(err):
        row_sort(x)
    with pytest.raises(err):
        row_sort_reference(x)


def test_widest_rows_are_taken():
    for dtype, width in ((torch.int64, 16384), (torch.uint32, 32768)):
        x = torch.zeros(1, width, dtype=dtype)
        assert row_sort(x).shape == (1, width)


# --- the probes ------------------------------------------------------------


def test_sorting_family_runs_on_the_cpu():
    recs = list(sorting.run(torch.device("cpu"), small=True))
    assert all(r.correct for r in recs), [r.name for r in recs
                                          if not r.correct]
    names = {r.name for r in recs}
    for want in ("global_int64_sort_2^27", "global_32bit_sort_2^27",
                 "C4_rows2048_int64", "C5_rows2048_u32", "C6_rows8192_u32",
                 "A_global_int64_lanes", "A_global_32bit_lanes",
                 "E_searchsorted_offsets", "G_rows_int64_R130",
                 "I_row_segment_counts_1024"):
        assert want in names
    n = sorting.N_LANES // sorting.SMALL_CUT
    for r in sorting.SWEEP_R:
        assert f"B_rows_int64_R{r}_C{n // r}" in names
        assert f"C_rows_u32_R{r}_C{n // r}" in names
    assert sum(r.name.startswith("H_blockgather") for r in recs) == 4
    # rows within row_sort's width go through it, wider ones do not
    for r in recs:
        if r.detail and "dtype" in r.detail and len(r.detail["shape"]) == 2:
            fits = r.detail["shape"][1] <= MAX_WIDTH[
                8 if r.detail["dtype"] == "int64" else 4]
            assert (r.kernel == "row_sort") == fits, r.name


def test_one_int64_key_orders_as_the_tpu_two_key_sorts():
    """lax.sort of (hi, lo16) with num_keys=2, and of hi with the lo16
    payload where hi ties break either way, give the order of the int64
    key (hi << 16 | lo16)."""
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    hi[7::7] = hi[1:-6:7]  # ties in hi
    lo16 = rng.integers(0, 1 << 16, 4096).astype(np.uint16)
    sh, sl = jax.lax.sort((jnp.asarray(hi), jnp.asarray(lo16)), num_keys=2)
    key = torch.from_numpy((hi.astype(np.int64) << 16) | lo16)
    got = torch.sort(key).values.numpy()
    np.testing.assert_array_equal(got >> 16, np.asarray(sh))
    np.testing.assert_array_equal(got & 0xFFFF, np.asarray(sl))
    # rows: lax.sort(dimension=1) of the words against row_sort
    rows = hi.reshape(2, 2048)
    want = jax.lax.sort((jnp.asarray(rows),), dimension=1, num_keys=1)[0]
    np.testing.assert_array_equal(_np(row_sort(_t(rows)), np.uint32),
                                  np.asarray(want))


def test_row_segment_counts_consume_as_r3b():
    """probe_r3b.py:77-87's rowcounts value, max(count) + heads."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 3, (8, 50)).astype(np.uint32)
    new = jnp.concatenate([jnp.ones((8, 1), bool),
                           jnp.asarray(x[:, 1:] != x[:, :-1])], axis=1)
    pos = jnp.arange(50, dtype=jnp.int32)[None, :]
    b = jnp.where(new, pos, 50)
    sufmin = jax.lax.cummin(b, axis=1, reverse=True)
    nxt = jnp.concatenate([sufmin[:, 1:], jnp.full((8, 1), 50, jnp.int32)],
                          axis=1)
    cnt = jnp.where(new, nxt - pos, 0)
    want = int(jnp.max(cnt) + jnp.sum(new.astype(jnp.int32)))
    counts, head = sorting.row_segment_counts(_t(x))
    assert int(counts.max() + head.sum()) == want
    np.testing.assert_array_equal(np.sort(counts.numpy(), axis=1),
                                  np.sort(np.asarray(cnt), axis=1))
