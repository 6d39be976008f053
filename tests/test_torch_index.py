"""The port's indexes against ``kmer_tpu``'s on the same columns: the host
index's arrays and answers, the device sort, the lexicographic binary
search (with and without a fence), prefix bounds and ranges (the wrapped
all-t prefix, the empty prefix), pattern hits with truncation and cap
regrowth, the hash table slot for slot, and index files both ways."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmer_tpu.index as jindex
from kmer_tpu.io.datagen import generate_test_rows
from kmer_tpu.ops.predicates import contains, qkmer_mask_vector
from kmer_tpu.packed import PackedKmers as JaxPacked
from kmer_tpu.utils.checkpoint import load_index as jax_load_index
from kmer_tpu.utils.checkpoint import save_index as jax_save_index
from kmer_tpu_torch.index import (
    DeviceHashIndex,
    DeviceIndex,
    KmerIndex,
    device_sort_column,
    ladder_cap,
    prefix_upper_key,
    searchsorted_packed,
)
from kmer_tpu_torch.packed import KmerColumn, PackedKmers, hi_lo_from_key
from kmer_tpu_torch.utils.checkpoint import load_index, save_index


def _jax(host):
    return JaxPacked(hi=jnp.asarray(host.hi), lo=jnp.asarray(host.lo),
                     length=jnp.asarray(host.length))


@pytest.fixture(scope="module")
def dataset():
    kmers = [r[1].lower() for r in generate_test_rows(1500, seed=11)]
    kmers += ["", "a", "aa", "acga", "acga", "acgattac", "t" * 32, "t" * 31,
              "a" * 32, "t", "tt", "ttt" + "a" * 29]
    host = PackedKmers.from_strings(kmers)
    col = KmerColumn.from_packed(host, "cpu")
    return (kmers, host, col, KmerIndex.build(host),
            jindex.KmerIndex.build(JaxPacked.from_strings(kmers)),
            DeviceIndex.build(col), jindex.DeviceIndex.build(_jax(host)))


def _queries(strs):
    host = PackedKmers.from_strings(strs)
    col = KmerColumn.from_packed(host, "cpu")
    return host, col


EQ_PROBES = ["acga", "", "a", "aa", "t" * 32, "gggg", "acgattac", "c" * 31]
PREFIX_PROBES = ["", "a", "ac", "acga", "t", "tt", "t" * 16, "t" * 17,
                 "t" * 31, "t" * 32, "g" * 10, "ttt"]
PATTERN_PROBES = ["", "angry", "nnnn", "acgan", "r", "n", "wsbd", "acga",
                  "t" * 32, "u" * 4, "nacg", "nnnnnnnnnn", "n" * 32]


def test_host_index_matches(dataset):
    kmers, host, col, idx, jidx, _, _ = dataset
    for name in ("sorted_keys", "sorted_lens", "row_ids"):
        got, want = getattr(idx, name), getattr(jidx, name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for q in EQ_PROBES + kmers[::97]:
        np.testing.assert_array_equal(idx.search_eq(q), jidx.search_eq(q))
    for p in PREFIX_PROBES:
        np.testing.assert_array_equal(idx.search_prefix(p),
                                      jidx.search_prefix(p))
    for q in PATTERN_PROBES:
        np.testing.assert_array_equal(idx.search_pattern(q),
                                      jidx.search_pattern(q))


def test_device_sort_matches(dataset):
    kmers, host, col, idx, _, didx, jdidx = dataset
    sorted_col, rid = device_sort_column(col)
    hi, lo = hi_lo_from_key(sorted_col.key.numpy())
    np.testing.assert_array_equal(hi, np.asarray(jdidx.hi))
    np.testing.assert_array_equal(lo, np.asarray(jdidx.lo))
    np.testing.assert_array_equal(sorted_col.length.numpy(),
                                  np.asarray(jdidx.length))
    # stable within a group, so equal to the host index's order
    np.testing.assert_array_equal(rid.numpy(), idx.row_ids)
    assert torch.equal(didx.row_ids, rid)


@pytest.mark.parametrize("bits", [None, 8, 10, 18])
def test_searchsorted_matches(dataset, bits):
    kmers, host, col, idx, _, didx, jdidx = dataset
    rng = np.random.default_rng(3)
    strs = EQ_PROBES + [kmers[i] for i in rng.integers(0, len(kmers), 150)]
    qh, qc = _queries(strs)
    fence = None if bits is None else didx.build_fence(bits)
    jfence = None if bits is None else jdidx.build_fence(bits)
    if bits is not None:
        assert fence.steps == jfence.steps
        np.testing.assert_array_equal(fence.fence.numpy(),
                                      np.asarray(jfence.fence))
    for side in ("left", "right"):
        got = searchsorted_packed(didx.key, didx.length, qc.key, qc.length,
                                  side, fence)
        want = jindex.searchsorted_packed(
            jdidx.hi, jdidx.lo, jdidx.length, jnp.asarray(qh.hi),
            jnp.asarray(qh.lo), jnp.asarray(qh.length), side, jfence)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    left, right = didx.eq_ranges(qc.key, qc.length, fence)
    for i, s in enumerate(strs):
        assert int(right[i] - left[i]) == kmers.count(s), s


def test_fence_on_skewed_keys():
    ks = ["aaaaaaaaaaaa" + s for s in ("acgt", "cggt", "tttt", "acga", "acgt")]
    _, col = _queries(ks)
    idx = DeviceIndex.build(col)
    fence = idx.build_fence(bits=8)
    _, q = _queries([ks[0], "gggg"])
    for a, b in zip(idx.eq_ranges(q.key, q.length),
                    idx.eq_ranges(q.key, q.length, fence)):
        assert torch.equal(a, b)


def test_prefix_upper_key_matches():
    rng = np.random.default_rng(9)
    strs = ["t" * p for p in range(1, 33)] + [
        "".join("acgt"[c] for c in rng.integers(0, 4, rng.integers(1, 33)))
        for _ in range(300)]
    strs += ["c" + "t" * p for p in range(31)]  # the add crosses bit 63
    qh, qc = _queries(strs)
    ukey, wrapped = prefix_upper_key(qc.key, qc.length)
    uhi, ulo, jw = jindex.prefix_upper_key(
        jnp.asarray(qh.hi), jnp.asarray(qh.lo), jnp.asarray(qh.length))
    hi, lo = hi_lo_from_key(ukey.numpy())
    np.testing.assert_array_equal(hi, np.asarray(uhi))
    np.testing.assert_array_equal(lo, np.asarray(ulo))
    np.testing.assert_array_equal(wrapped.numpy(), np.asarray(jw))
    assert wrapped.tolist() == [set(s) == {"t"} for s in strs]


def test_prefix_ranges_match(dataset):
    kmers, host, col, idx, _, didx, jdidx = dataset
    qh, qc = _queries(PREFIX_PROBES)
    left, right = didx.prefix_ranges(qc.key, qc.length)
    jl, jr = jdidx.prefix_ranges(jnp.asarray(qh.hi), jnp.asarray(qh.lo),
                                 jnp.asarray(qh.length))
    np.testing.assert_array_equal(left.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(right.numpy(), np.asarray(jr))
    cap = int((right - left).max()) + 1
    rows, valid = didx.gather_rows(left, right, cap)
    for i, p in enumerate(PREFIX_PROBES):
        got = np.sort(rows[i][valid[i]].numpy())
        np.testing.assert_array_equal(got, idx.search_prefix(p))
    # "aca" must not return the shorter "ac" (same packed key)
    d2 = DeviceIndex.build(_queries(["ac", "aca", "acaa", "acg", "a"])[1])
    _, q = _queries(["aca"])
    rows, valid = d2.gather_rows(*d2.prefix_ranges(q.key, q.length), cap=8)
    assert sorted(rows[0][valid[0]].tolist()) == [1, 2]


def test_prefix_ranges_with_fence_match(dataset):
    kmers, host, col, idx, _, didx, _ = dataset
    fence = didx.build_fence(bits=10)
    _, qc = _queries(PREFIX_PROBES + kmers[::50])
    for a, b in zip(didx.prefix_ranges(qc.key, qc.length),
                    didx.prefix_ranges(qc.key, qc.length, fence)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("qlen, cap", [(4, 4), (4, 1 << 12), (5, 8),
                                       (1, 2), (32, 8)])
def test_pattern_hits_match(dataset, qlen, cap):
    kmers, host, col, idx, _, didx, jdidx = dataset
    rng = np.random.default_rng(qlen)
    pats = ["n" * qlen, "a" * qlen, "t" * qlen, ("acgr" * 8)[:qlen]]
    pats += ["".join("acgtnrykmswbdhvu"[c] for c in rng.integers(0, 16, qlen))
             for _ in range(6)]
    masks = np.stack([qkmer_mask_vector(p)[0] for p in pats])
    rows, hit, trunc = didx.pattern_hits(torch.from_numpy(masks.astype(
        np.int64)), qlen=qlen, cap=cap)
    jrows, jhit, jtrunc = jdidx.pattern_hits(jnp.asarray(masks), qlen=qlen,
                                             cap=cap)
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    jrows, jhit = np.asarray(jrows), np.asarray(jhit)
    for i, p in enumerate(pats):
        got = np.sort(rows[i][hit[i]].numpy())
        np.testing.assert_array_equal(got, np.sort(jrows[i][jhit[i]]))
        if not bool(trunc[i]):
            want = [j for j, s in enumerate(kmers) if contains(p, s)]
            assert got.tolist() == want, p
    if cap < len(didx):
        assert bool(trunc[0])  # all-'n' spans the whole length bucket


def test_search_pattern_batch_regrows_like_kmer_tpu():
    """The port's search issues the groups and caps that kmer_tpu's
    ``pattern_search_grouped`` issues over the same pattern_hits, and
    answers as the host index does."""
    rows = [r[1].lower() for r in generate_test_rows(300, seed=31)]
    rows += ["acga"] * 40 + ["", ""]
    host = PackedKmers.from_strings(rows)
    didx = DeviceIndex.build(KmerColumn.from_packed(host, "cpu"))
    probes = ["nnnn", "angr", "rygw", "acga", "n", "", "nnnnnnnnnnnnn"]
    calls, jcalls = [], []
    inner = didx.pattern_hits

    def spy(masks, qlen, cap):
        calls.append((qlen, cap))
        return inner(masks, qlen=qlen, cap=cap)

    object.__setattr__(didx, "pattern_hits", spy)
    got = didx.search_pattern_batch(probes, cap=4)

    def group_fn(qlen, masks, c):
        jcalls.append((qlen, c))
        r, ok, trunc = inner(masks, qlen=qlen, cap=c)
        return ([np.sort(r[j][ok[j]].numpy()) for j in range(r.shape[0])],
                bool(trunc.any()))

    zero = np.sort(didx.row_ids[didx.length == 0].numpy())
    want = jindex.pattern_search_grouped(probes, zero, group_fn, 4,
                                         cap_limit=len(didx))
    assert calls == jcalls and max(c for _, c in calls) > 8  # regrown
    host_idx = KmerIndex.build(host)
    for q, g, w in zip(probes, got, want):
        assert g.tolist() == w.tolist() == host_idx.search_pattern(q).tolist()
    assert got[5].tolist() == [340, 341]


def test_ladder_cap_matches():
    for cap in (0, 1, 8, 9, 33, 500, 5000):
        for limit in (0, 7, 100, 1 << 20):
            assert ladder_cap(cap, limit) == jindex.ladder_cap(cap, limit)


@pytest.mark.parametrize("load", [0.25, 4.0])
def test_hash_index_matches_slot_for_slot(dataset, load):
    kmers, host, col, idx, _, _, _ = dataset
    h = DeviceHashIndex.build(host, load=load, device="cpu")
    jh = jindex.DeviceHashIndex.build(_jax(host), load=load)
    np.testing.assert_array_equal(h.table.numpy(), np.asarray(jh.table))
    np.testing.assert_array_equal(h.row_ids.numpy(), np.asarray(jh.row_ids))
    assert (h.max_chain, h.n_unique) == (jh.max_chain, jh.n_unique)
    if load > 1:
        assert h.max_chain > 1
    queries = list(dict.fromkeys(kmers))[::7] + ["gggg", "c" * 31, ""]
    qh, qc = _queries(queries)
    start, count, found = h.lookup_eq(qc.key, qc.length)
    js, jc, jf = jh.lookup_eq(jnp.asarray(qh.hi), jnp.asarray(qh.lo),
                              jnp.asarray(qh.length))
    np.testing.assert_array_equal(start.numpy(), np.asarray(js))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jf))
    rows, valid = h.gather_rows(start, count, int(count.max()))
    for i, q in enumerate(queries):
        got = np.sort(rows[i][valid[i]].numpy())
        np.testing.assert_array_equal(got, idx.search_eq(q))
        assert bool(found[i]) == (got.size > 0)


def test_empty_index():
    empty = PackedKmers.from_strings([])
    didx = DeviceIndex.build(KmerColumn.from_packed(empty, "cpu"))
    _, q = _queries(["acg", ""])
    left, right = didx.eq_ranges(q.key, q.length)
    assert left.tolist() == right.tolist() == [0, 0]
    assert all(r.size == 0 for r in didx.search_pattern_batch(["n", ""]))


def test_index_files_load_in_both_packages(dataset, tmp_path):
    kmers, host, col, idx, jidx, _, _ = dataset
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "j.npz")
    save_index(idx, port_path, {"rows": len(kmers)})
    jax_save_index(jidx, jax_path, {"rows": len(kmers)})
    back, meta = jax_load_index(port_path)
    mine, jmeta = load_index(jax_path)
    assert meta == jmeta == {"version": 1, "rows": len(kmers)}
    for name in ("sorted_keys", "sorted_lens", "row_ids"):
        np.testing.assert_array_equal(getattr(back, name), getattr(idx, name))
        np.testing.assert_array_equal(getattr(mine, name),
                                      getattr(jidx, name))
    assert mine.search_prefix("ac").tolist() == idx.search_prefix("ac").tolist()
