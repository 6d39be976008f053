"""The port's wide accumulator (kmer_tpu_torch.ops.wide) vs kmer_tpu's
(JAX on the CPU), on the same seeded numpy inputs.

Trimmed (hi, lo, length) and 64-bit counts are compared exactly (the
tolerance is zero), and so are error strings.  The case list follows
tests/test_wide.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import kmer_tpu.ops.wide as jw
from kmer_tpu.ops.count import count_column, count_dna
from kmer_tpu.ops.count import count_windows as jax_count_windows
from kmer_tpu.packed import PackedKmers as JaxPacked
from kmer_tpu_torch.ops import wide
from kmer_tpu_torch.ops.count import SENTINEL_KEY, SENTINEL_LEN, CountTable
from kmer_tpu_torch.ops.wide import WideAccumulator, WideCounts
from kmer_tpu_torch.packed import SIGN_FLIP, key_from_hi_lo


def _windows(rng, n, k, masked=False, pool=None):
    """Left-aligned k-mer keys as (hi, lo) uint32 lanes; drawn from
    ``pool`` distinct keys when given (duplicate-heavy)."""
    bits = 2 * k
    m = pool or n
    hi = rng.integers(0, 2 ** min(32, bits), m, dtype=np.uint64)
    hi <<= np.uint64(max(0, 32 - bits))
    lo = np.zeros(m, np.uint64)
    if bits > 32:
        lo = rng.integers(0, 2 ** (bits - 32), m, dtype=np.uint64)
        lo <<= np.uint64(64 - bits)
    if pool:
        sel = rng.integers(0, pool, n)
        hi, lo = hi[sel], lo[sel]
    hi[::7] |= np.uint64(0x80000000)  # keys with the top bit set
    hi &= np.uint64(((1 << min(32, bits)) - 1) << max(0, 32 - bits))
    valid = rng.random(n) < 0.85 if masked else None
    return hi.astype(np.uint32), lo.astype(np.uint32), valid


def _port_keys(hi, lo, valid):
    keys = torch.from_numpy(key_from_hi_lo(hi, lo).copy())
    return keys, None if valid is None else torch.from_numpy(valid)


def _jax_wide(hi, lo, length, counts_hi, counts_lo, n_unique=None):
    live = (np.asarray(counts_hi) > 0) | (np.asarray(counts_lo) > 0)
    return jw.WideCounts(
        hi=jnp.asarray(hi, jnp.uint32), lo=jnp.asarray(lo, jnp.uint32),
        length=jnp.asarray(length, jnp.int32),
        counts_hi=jnp.asarray(counts_hi, jnp.int32),
        counts_lo=jnp.asarray(counts_lo, jnp.uint32),
        n_unique=jnp.asarray(live.sum() if n_unique is None else n_unique,
                             jnp.int32))


def _port_table(jt):
    """A port CountTable with the slots of a kmer_tpu CountTable."""
    return CountTable.from_numpy(np.asarray(jt.hi), np.asarray(jt.lo),
                                 np.asarray(jt.length), np.asarray(jt.counts))


def _assert_same(got: WideCounts, want, n_unique=True):
    t, w = got.trim(), want.trim()
    hi, lo, length, _, _ = t.to_numpy()
    np.testing.assert_array_equal(hi, np.asarray(w.hi, np.uint32))
    np.testing.assert_array_equal(lo, np.asarray(w.lo, np.uint32))
    np.testing.assert_array_equal(length, np.asarray(w.length, np.int32))
    np.testing.assert_array_equal(t.counts64(), w.counts64())
    if n_unique:
        assert got.distinct() == int(want.n_unique)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [5, 15, 16, 21, 23, 24, 31, 32])
def test_fold_matches_kmer_tpu(k, masked):
    rng = np.random.default_rng(k * 2 + masked)
    acc = WideCounts.empty(512)
    jacc = jw.WideCounts.empty(512)
    for _ in range(3):
        hi, lo, valid = _windows(rng, 300, k, masked)
        acc = wide.fold_windows_into_wide(acc, *_port_keys(hi, lo, valid), k)
        jacc = jw.fold_windows_into_wide(
            jacc, jnp.asarray(hi), jnp.asarray(lo),
            None if valid is None else jnp.asarray(valid), k)
    assert acc.capacity == 512
    _assert_same(acc, jacc)


@pytest.mark.parametrize("k", [21, 32])
def test_fold_duplicate_heavy(k):
    rng = np.random.default_rng(40 + k)
    acc, jacc = WideCounts.empty(64), jw.WideCounts.empty(64)
    for _ in range(4):
        hi, lo, valid = _windows(rng, 2000, k, masked=True, pool=40)
        acc = wide.fold_windows_into_wide(acc, *_port_keys(hi, lo, valid), k)
        jacc = jw.fold_windows_into_wide(jacc, jnp.asarray(hi),
                                         jnp.asarray(lo), jnp.asarray(valid),
                                         k)
    _assert_same(acc, jacc)
    assert acc.total() == jacc.total()


@pytest.mark.parametrize("k", [16, 24, 32])
def test_fold_all_t(k):
    """The all-t key, which equals the sentinel's bits at k = 32, is a
    live row like any other."""
    n, bits = 200, 2 * k
    hi = np.full(n, 0xFFFFFFFF, np.uint32)
    lo = np.full(n, (0xFFFFFFFF << max(0, 64 - bits)) & 0xFFFFFFFF
                 if bits > 32 else 0, np.uint32)
    valid = np.arange(n) % 4 != 3
    got = wide.fold_windows_into_wide(WideCounts.empty(64),
                                      *_port_keys(hi, lo, valid), k)
    want = jw.fold_windows_into_wide(jw.WideCounts.empty(64),
                                     jnp.asarray(hi), jnp.asarray(lo),
                                     jnp.asarray(valid), k)
    _assert_same(got, want)
    assert got.distinct() == 1 and got.trim().counts64().tolist() == [150]
    # folding it again keeps one row: liveness is counts > 0, not the key
    again = wide.fold_windows_into_wide(got, *_port_keys(hi, lo, valid), k)
    assert again.trim().counts64().tolist() == [300]


def test_fold_counts_past_2_31():
    """Folding onto an accumulator seeded past 2^32 (through from_numpy,
    in kmer_tpu's lanes) stays exact."""
    k = 21
    hi = np.asarray([0x12345600, 0xABCDEF00], np.uint32)
    lo = np.asarray([0x55530000, 0xAAA80000], np.uint32)
    big = 6_000_000_000
    lanes = (np.r_[hi[:1], np.full(15, 0xFFFFFFFF, np.uint32)],
             np.r_[lo[:1], np.full(15, 0xFFFFFFFF, np.uint32)],
             np.r_[np.int32(k), np.full(15, SENTINEL_LEN, np.int32)],
             np.r_[np.int32(big >> 32), np.zeros(15, np.int32)],
             np.r_[np.uint32(big & 0xFFFFFFFF), np.zeros(15, np.uint32)])
    acc = WideCounts.from_numpy(*lanes)
    for got, want in zip(acc.to_numpy(), lanes):
        np.testing.assert_array_equal(got, want)
    got = wide.fold_windows_into_wide(acc, *_port_keys(hi, lo, None), k)
    want = jw.fold_windows_into_wide(_jax_wide(*lanes), jnp.asarray(hi),
                                     jnp.asarray(lo), None, k)
    _assert_same(got, want)
    assert sorted(got.trim().counts64().tolist()) == [1, big + 1]


def test_fold_overflow_signal():
    rng = np.random.default_rng(3)
    hi, lo, _ = _windows(rng, 300, 21)
    got = wide.fold_windows_into_wide(WideCounts.empty(8),
                                      *_port_keys(hi, lo, None), 21)
    want = jw.fold_windows_into_wide(jw.WideCounts.empty(8), jnp.asarray(hi),
                                     jnp.asarray(lo), None, 21)
    assert got.capacity == 8
    assert got.distinct() > 8 and int(want.n_unique) > 8
    assert got.distinct() == len(set(zip(hi.tolist(), lo.tolist())))


@pytest.mark.parametrize("k", [8, 15, 16, 21, 23, 24, 31, 32])
def test_dead_slot_invariant(k):
    """Live rows at the front in ascending unsigned key order; dead slots
    hold SENTINEL_KEY, SENTINEL_LEN and 0."""
    rng = np.random.default_rng(k)
    acc = WideCounts.empty(1024)
    for _ in range(2):
        hi, lo, valid = _windows(rng, 300, k, masked=True, pool=150)
        acc = wide.fold_windows_into_wide(acc, *_port_keys(hi, lo, valid), k)
    n = acc.distinct()
    live = acc.counts > 0
    assert 0 < n < acc.capacity
    assert bool(live[:n].all()) and not bool(live[n:].any())
    assert bool((acc.keys[n:] == SENTINEL_KEY).all())
    assert bool((acc.length[n:] == int(SENTINEL_LEN)).all())
    assert bool((acc.length[:n] == k).all())
    flipped = acc.keys[:n] ^ SIGN_FLIP
    assert bool((flipped[1:] > flipped[:-1]).all())


def _strs(rng, n, lmax=4):
    return ["".join(rng.choice(list("acgt"), int(rng.integers(1, lmax + 1))))
            for _ in range(n)]


def test_merges_past_2_31_match_kmer_tpu():
    """merge_into_wide, wide_from_table and merge_wide with keys of mixed
    lengths ("t" and "ta" share their key bits) and totals past 2^32."""
    col = JaxPacked.from_strings(["acgt", "acgt", "ttt", "t", "ta", "t"])
    big = 2**31 - 100
    from kmer_tpu.ops.count import count_packed

    a = count_packed(col.hi, col.lo, col.length,
                     jnp.asarray([big, 7, 5, 3, 2, big], jnp.int32))
    b = count_packed(col.hi, col.lo, col.length,
                     jnp.asarray([big, 11, 9, 0, 4, 1], jnp.int32))
    acc = wide.wide_from_table(_port_table(a), capacity=8)
    jacc = jw.wide_from_table(a, capacity=8)
    _assert_same(acc, jacc)
    acc = wide.merge_into_wide(acc, _port_table(b))
    jacc = jw.merge_into_wide(jacc, b)
    _assert_same(acc, jacc)
    d = acc.to_dict()
    assert d == jacc.to_dict()
    assert d["acgt"] == 2 * big + 18 and d["t"] == 3 + big + 1
    assert acc.total() == jacc.total()
    # merge_wide with itself doubles every count, keys unchanged
    both = wide.merge_wide(acc, acc)
    _assert_same(both, jw.merge_wide(jacc, jacc))
    assert both.to_dict() == {s: 2 * c for s, c in d.items()}


def test_merge_wide_associative_and_default_capacity():
    rng = np.random.default_rng(5)
    jts = [count_column(JaxPacked.from_strings(_strs(rng, 40)))
           for _ in range(3)]
    a, b, c = (wide.wide_from_table(_port_table(t)) for t in jts)
    ja, jb, jc = (jw.wide_from_table(t) for t in jts)
    assert a.capacity == jts[0].hi.shape[-1]
    left = wide.merge_wide(wide.merge_wide(a, b, 256), c, 256)
    right = wide.merge_wide(a, wide.merge_wide(b, c, 256), 256)
    want = jw.merge_wide(jw.merge_wide(ja, jb, 256), jc, 256)
    _assert_same(left, want)
    _assert_same(right, want)


def test_count_packed_wide_matches_kmer_tpu():
    """The general weighted GROUP BY: a key in many slots, zero weights
    absent, 64-bit weights, mixed lengths; then an overflowing capacity."""
    rng = np.random.default_rng(6)
    col = JaxPacked.from_strings(_strs(rng, 400, lmax=3))
    w = rng.integers(0, 1 << 40, 400, dtype=np.int64)
    w[::5] = 0
    w_hi = (w >> 32).astype(np.int32)
    w_lo = (w & 0xFFFFFFFF).astype(np.uint32)
    keys = torch.from_numpy(key_from_hi_lo(col.hi, col.lo).copy())
    length = torch.from_numpy(np.asarray(col.length, np.int32))
    got = wide.count_packed_wide(keys, length, torch.from_numpy(w), 400)
    want = jw.count_packed_wide(col.hi, col.lo, col.length, jnp.asarray(w_hi),
                                jnp.asarray(w_lo), capacity=400)
    _assert_same(got, want)
    small = wide.count_packed_wide(keys, length, torch.from_numpy(w), 8)
    assert small.capacity == 8 and small.distinct() == got.distinct() > 8
    # the 8 rows kept are the 8 smallest groups, in order
    for a, b in zip(small.trim().to_numpy(), got.trim().to_numpy()):
        np.testing.assert_array_equal(a, b[:8])


def test_pad_wide_matches_kmer_tpu():
    rng = np.random.default_rng(7)
    hi, lo, _ = _windows(rng, 50, 21)
    acc = wide.fold_windows_into_wide(WideCounts.empty(64),
                                      *_port_keys(hi, lo, None), 21)
    jacc = jw.fold_windows_into_wide(jw.WideCounts.empty(64),
                                     jnp.asarray(hi), jnp.asarray(lo),
                                     None, 21)
    assert wide.pad_wide(acc, 32) is acc
    big = wide.pad_wide(acc, 256)
    jbig = jw.pad_wide(jacc, 256)
    assert big.capacity == 256 and big.distinct() == acc.distinct()
    for got, want in zip(big.to_numpy(),
                         (jbig.hi, jbig.lo, jbig.length, jbig.counts_hi,
                          jbig.counts_lo)):
        np.testing.assert_array_equal(got, np.asarray(want))


def _runs(seqs, k=5):
    jruns = [jw.wide_from_table(count_dna(s, k)).trim() for s in seqs]
    runs = [WideCounts.from_numpy(*(np.asarray(a) for a in (
        t.hi, t.lo, t.length, t.counts_hi, t.counts_lo))) for t in jruns]
    return runs, jruns


def test_merge_runs_device_vs_host_and_kmer_tpu():
    seqs = ("ACGTACGTACGTAAAA", "ACGTACGTTTTTGGGG", "ACGTACGTACGTAAAA")
    runs, jruns = _runs(seqs)
    dev = wide.merge_runs(runs, prefer_device=True, device="cpu")
    host = wide.merge_runs(runs, prefer_device=False, device="cpu")
    want = jw.merge_runs(jruns, prefer_device=False)
    _assert_same(dev, want)
    _assert_same(host, want)
    assert dev.capacity == host.capacity == dev.distinct()


def test_merge_runs_past_2_31_and_empty():
    big = 3_000_000_000
    lanes = ([42], [0], [8], [big >> 32], [big & 0xFFFFFFFF])
    run = WideCounts.from_numpy(*(np.asarray(x) for x in lanes))
    for prefer in (True, False):
        merged = wide.merge_runs([run, run, run], prefer, device="cpu")
        assert merged.counts64().tolist() == [3 * big]
        assert wide.merge_runs([], prefer, device="cpu").distinct() == 0


def _jax_tables(seed, n_batches, n, k, pool=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        hi, lo, valid = _windows(rng, n, k, masked=True, pool=pool)
        out.append(jax_count_windows(jnp.asarray(hi), jnp.asarray(lo),
                                     jnp.asarray(valid), k))
    return out


def test_accumulator_growth_matches_kmer_tpu():
    tables = _jax_tables(8, 12, 60, 9)
    acc = WideAccumulator(capacity=8, device="cpu")
    jacc = jw.WideAccumulator(capacity=8)
    for t in tables:
        acc.add(_port_table(t))
        jacc.add(t)
    assert acc.capacity == jacc.capacity
    _assert_same(acc.result(), jacc.result())


@pytest.mark.parametrize("to_dir", [False, True])
def test_accumulator_spill_matches_kmer_tpu(tmp_path, to_dir):
    tables = _jax_tables(9, 10, 300, 9)
    sd = str(tmp_path) if to_dir else None
    acc = WideAccumulator(capacity=64, max_capacity=600, spill_dir=sd,
                          device="cpu")
    jacc = jw.WideAccumulator(capacity=64, max_capacity=600,
                              spill_dir=str(tmp_path / "j") if to_dir
                              else None)
    if to_dir:
        (tmp_path / "j").mkdir()
    for t in tables:
        acc.add(_port_table(t))
        jacc.add(t)
    assert acc.capacity == jacc.capacity == 512  # budget rounded down
    assert acc.n_spills == jacc.n_spills > 0
    _assert_same(acc.result(), jacc.result())
    if to_dir:
        assert sorted(p.name for p in tmp_path.glob("spill_*.npz")) == \
            sorted(p.name for p in (tmp_path / "j").glob("spill_*.npz"))


def test_accumulator_budget_error_text_and_empty():
    tables = [count_dna("ACGT" * 40, 7), count_dna("TTTT" * 40, 7)]
    errors = []
    for acc, conv in ((WideAccumulator(1 << 4, max_capacity=1 << 5,
                                       device="cpu"), _port_table),
                      (jw.WideAccumulator(1 << 4, max_capacity=1 << 5),
                       lambda t: t)):
        with pytest.raises(ValueError) as err:
            for t in tables:
                acc.add(conv(t))
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "exceeds max_capacity 32; shrink the batch" in errors[0]
    with pytest.raises(ValueError, match="empty accumulator"):
        WideAccumulator(device="cpu").result()


def test_accumulator_seed_resumes():
    tables = _jax_tables(10, 6, 80, 11)
    straight = WideAccumulator(capacity=16, device="cpu")
    for t in tables:
        straight.add(_port_table(t))
    first = WideAccumulator(capacity=16, device="cpu")
    for t in tables[:3]:
        first.add(_port_table(t))
    resumed = WideAccumulator(device="cpu")
    resumed.seed(first.result())
    for t in tables[3:]:
        resumed.add(_port_table(t))
    _assert_same(resumed.result(), jw.WideCounts(
        *(jnp.asarray(a) for a in straight.result().to_numpy()),
        n_unique=jnp.asarray(straight.result().distinct())))


def test_numpy_lanes_round_trip_and_dict():
    jts = _jax_tables(11, 1, 200, 13)
    jacc = jw.wide_from_table(jts[0], capacity=256)
    lanes = [np.asarray(a) for a in (jacc.hi, jacc.lo, jacc.length,
                                     jacc.counts_hi, jacc.counts_lo)]
    acc = WideCounts.from_numpy(*lanes)
    assert acc.capacity == 256 and acc.distinct() == int(jacc.n_unique)
    for got, want in zip(acc.to_numpy(), lanes):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert acc.to_dict() == jacc.to_dict()
    assert acc.total() == jacc.total()
    np.testing.assert_array_equal(acc.counts64(), jacc.counts64())
    assert WideCounts.empty(4).to_dict() == {} and \
        WideCounts.empty(4).total() == 0
