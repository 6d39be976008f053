"""The port's predicates (scalar and vector), hash and GROUP BY against
``kmer_tpu``'s on the same numpy-seeded columns: the same answers, the
same hash bits, and array-equal trimmed tables."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmer_tpu.ops.predicates as jpred
from kmer_tpu.ops.count import count_column as jax_count_column
from kmer_tpu.ops.count import count_dna as jax_count_dna
from kmer_tpu.ops.count import count_kmers as jax_count_kmers
from kmer_tpu.ops.count import count_packed as jax_count_packed
from kmer_tpu.ops.count import merge_tables as jax_merge_tables
from kmer_tpu.packed import PackedKmers as JaxPacked
import kmer_tpu_torch.ops.predicates as pred
from kmer_tpu_torch.ops.count import (
    count_column,
    count_dna,
    count_kmers,
    count_packed,
    merge_tables,
)
from kmer_tpu_torch.packed import KmerColumn, PackedKmers, key_from_hi_lo

LENGTHS = (0, 1, 16, 17, 31, 32)


def _strings(seed, n=600):
    """Random kmers of lengths 0, 1, 16, 17, 31, 32 and 1..32, many
    t-leading (bit 63 set), with equal-key/different-length groups."""
    rng = np.random.default_rng(seed)
    out = ["", "a", "aa", "aaa", "t" * 32, "t" * 31, "t", "tt" * 8]
    for _ in range(n):
        k = int(rng.choice(LENGTHS)) if rng.random() < 0.5 else int(
            rng.integers(1, 33))
        codes = rng.integers(0, 4, k)
        if k and rng.random() < 0.4:
            codes[0] = 3
        out.append("".join("acgt"[c] for c in codes))
    dup = [out[int(i)] for i in rng.integers(0, len(out), n // 3)]
    return out + dup


@pytest.fixture(scope="module")
def column():
    strs = _strings(1)
    host = PackedKmers.from_strings(strs)
    jcol = JaxPacked(hi=jnp.asarray(host.hi), lo=jnp.asarray(host.lo),
                     length=jnp.asarray(host.length))
    return strs, KmerColumn.from_packed(host, "cpu"), jcol


SCALAR_POOL = [None, "", "a", "A", "ac", "acg", "acgt", "acgtacgt", "t",
               "t" * 16, "t" * 17, "t" * 31, "t" * 32, "g" * 32]
PATTERN_POOL = [None, "", "n", "u", "r", "acgt", "rcgt", "angry", "nnnn",
                "t" * 32, "n" * 32, "ACNTANGT", "wsbd", "nt" * 8]


@pytest.mark.parametrize("a", SCALAR_POOL)
def test_scalar_kmer_predicates_match(a):
    for b in SCALAR_POOL:
        for name in ("equals", "starts_with", "starts_with_op"):
            assert getattr(pred, name)(a, b) == getattr(jpred, name)(a, b), (
                name, a, b)
    if a is not None:
        assert pred.kmer_hash(a) == jpred.kmer_hash(a)


@pytest.mark.parametrize("q", PATTERN_POOL)
def test_scalar_pattern_predicates_match(q):
    for b in SCALAR_POOL + ["acgtacgt", "aggrt"[:0] or "aggt"]:
        assert pred.contains(q, b) == jpred.contains(q, b), (q, b)
        assert pred.containing(b, q) == jpred.containing(b, q), (q, b)
    if q is not None:
        got, want = pred.qkmer_mask_vector(q), jpred.qkmer_mask_vector(q)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def _probe(s):
    p = PackedKmers.from_strings([s])
    return (KmerColumn.from_packed(p, "cpu")[0],
            JaxPacked(hi=jnp.uint32(p.hi[0]), lo=jnp.uint32(p.lo[0]),
                      length=jnp.int32(p.length[0])))


@pytest.mark.parametrize("k", LENGTHS)
def test_vector_kmer_predicates_match(column, k):
    strs, col, jcol = column
    rng = np.random.default_rng(k)
    queries = [s for s in strs if len(s) == k][:3] + ["t" * k]
    if k:
        queries.append("".join("acgt"[c] for c in rng.integers(0, 4, k)))
    for q in queries:
        probe, jprobe = _probe(q)
        for fn, jfn in ((pred.v_equals, jpred.v_equals),
                        (pred.v_starts_with, jpred.v_starts_with)):
            np.testing.assert_array_equal(fn(col, probe).numpy(),
                                          np.asarray(jfn(jcol, jprobe)))


@pytest.mark.parametrize("q", ["", "n", "t", "angry", "nnnnnnnnnnnnnnnnn",
                               "t" * 31, "n" * 32, "tnnnnnnnnnnnnnnn", "u"])
def test_v_contains_matches(column, q):
    strs, col, jcol = column
    masks, qlen = pred.qkmer_mask_vector(q)
    got = pred.v_contains(col, masks, qlen).numpy()
    want = np.asarray(jpred.v_contains(jcol, jnp.asarray(masks), qlen))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [bool(jpred.contains(q, s)) for s in strs]


def test_v_hash_bit_equal_on_random_keys():
    rng = np.random.default_rng(5)
    n = 100_000
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    ln = rng.integers(0, 33, n).astype(np.int32)
    col = KmerColumn(key=torch.from_numpy(key_from_hi_lo(hi, lo)),
                     length=torch.from_numpy(ln))
    want = jpred._hash_finalize_np(hi, lo, ln).view(np.int32)
    np.testing.assert_array_equal(pred.v_hash(col).numpy(), want)
    jcol = JaxPacked(hi=jnp.asarray(hi), lo=jnp.asarray(lo),
                     length=jnp.asarray(ln))
    np.testing.assert_array_equal(np.asarray(jpred.v_hash(jcol)), want)


def _trimmed(t):
    return [np.asarray(a) for a in t.trim().to_numpy()]


def _jax_trimmed(t):
    tt = t.trim()
    return [np.asarray(a) for a in (tt.hi, tt.lo, tt.length, tt.counts)]


def _assert_tables(port, ref):
    for g, w in zip(_trimmed(port), _jax_trimmed(ref)):
        np.testing.assert_array_equal(g, w)
    assert port.distinct() == ref.distinct()
    assert port.total() == ref.total()
    assert port.to_dict() == ref.to_dict()


@pytest.mark.parametrize("seed, wmax", [(0, 1), (1, 6), (2, 1 << 20)])
def test_count_packed_matches(seed, wmax):
    strs = _strings(seed + 10, 400)
    host = PackedKmers.from_strings(strs)
    rng = np.random.default_rng(seed)
    w = rng.integers(0, wmax + 1, len(strs)).astype(np.int32)
    w[::7] = 0
    col = KmerColumn.from_packed(host, "cpu")
    port = count_packed(col.key, col.length, torch.from_numpy(w))
    ref = jax_count_packed(host.hi, host.lo, host.length, w)
    _assert_tables(port, ref)
    assert port.capacity == len(strs)


def test_count_column_and_merge_match(column):
    strs, col, jcol = column
    valid = np.random.default_rng(3).random(len(strs)) < 0.7
    a = count_column(col)
    b = count_column(col, valid=torch.from_numpy(valid))
    ja = jax_count_column(jcol)
    jb = jax_count_column(jcol, valid=jnp.asarray(valid))
    _assert_tables(a, ja)
    _assert_tables(b, jb)
    _assert_tables(merge_tables(a, b), jax_merge_tables(ja, jb))
    # 'a', 'aa', 'aaa' and '' share key 0: four groups, not one
    d = a.to_dict()
    assert all(d[s] >= 1 for s in ("", "a", "aa", "aaa"))


@pytest.mark.parametrize("dna, k, canonical", [
    ("ACGTACGT", 4, False), ("ACGTACGT" * 5 + "TTTT", 3, True),
    ("GATTACA" * 9, 32, False), ("T" * 40, 17, True)])
def test_count_dna_matches(dna, k, canonical):
    _assert_tables(count_dna(dna, k, canonical, device="cpu"),
                   jax_count_dna(dna, k, canonical))


def test_count_kmers_matches_on_padded_reads():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, (16, 40)).astype(np.uint8)
    codes[:4, 0] = 3
    lengths = rng.integers(0, 41, 16).astype(np.int32)
    for k, canonical in ((21, True), (5, False)):
        got = count_kmers(torch.from_numpy(codes), torch.from_numpy(lengths),
                          k, canonical)
        want = jax_count_kmers(jnp.asarray(codes), jnp.asarray(lengths), k,
                               canonical)
        _assert_tables(got, want)


def test_count_dna_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        count_dna("ACGT", 2, device="cuda")
