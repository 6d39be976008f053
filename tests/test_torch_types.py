"""The port's value types, codec, packing, generate_kmers and test-data
generator against ``kmer_tpu``'s: the same strings, the same error
classes and messages, the same lanes and the same rows."""

import numpy as np
import pytest

import kmer_tpu.codec as jcodec
from kmer_tpu import errors as jerrors
from kmer_tpu.io.datagen import generate_test_rows as jax_rows
from kmer_tpu.io.datagen import rows_to_csv as jax_rows_to_csv
from kmer_tpu.ops.extract import extract_to_strings as jax_extract
from kmer_tpu.ops.predicates import length as jax_length
from kmer_tpu.packed import PackedKmers as JaxPacked
from kmer_tpu.packed import concat as jax_concat
from kmer_tpu.types import Dna as JDna
from kmer_tpu.types import Kmer as JKmer
from kmer_tpu.types import Qkmer as JQkmer
from kmer_tpu_torch import codec
from kmer_tpu_torch import errors
from kmer_tpu_torch.io.datagen import generate_test_rows, rows_to_csv
from kmer_tpu_torch.ops.extract import extract_to_strings, generate_kmers
from kmer_tpu_torch.ops.predicates import length
from kmer_tpu_torch.packed import KmerColumn, PackedKmers, concat
from kmer_tpu_torch.types import Dna, Kmer, Qkmer

LITERALS = [
    "", "a", "ACGT", "acgt", "AAAACCCCGGGGTTTT", "t" * 16, "t" * 17,
    "g" * 31, "t" * 32, "a" * 33, "ACGTN", "AGTC N", "acgtu", "U",
    "angry", "RYKMSWBDHVN", "rykmswbdhvn", "ACGT123", "N" * 32,
    "n" * 33, "x" * 40, "tacgtacgtacgtacgtacgtacgtacgtacgt",
]
TYPES = [(Dna, JDna), (Kmer, JKmer), (Qkmer, JQkmer)]


def _outcome(cls, value):
    """str() of the value, or (error class name, message)."""
    try:
        return str(cls(value))
    except jerrors.KmerEngineError as e:
        return type(e).__name__, str(e)
    except errors.KmerEngineError as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("types", TYPES, ids=["dna", "kmer", "qkmer"])
@pytest.mark.parametrize("value", LITERALS)
def test_type_parse_matches_kmer_tpu(types, value):
    port, ref = types
    assert _outcome(port, value) == _outcome(ref, value)


def test_error_classes_match_kmer_tpu():
    for name in ("InvalidDnaSequenceError", "KmerTooLongError",
                 "InvalidQkmerSequenceError", "QkmerTooLongError",
                 "InvalidKmerLengthError"):
        port, ref = getattr(errors, name), getattr(jerrors, name)
        assert port.message == ref.message and port.detail == ref.detail
        assert issubclass(port, errors.KmerEngineError)
        assert issubclass(port, ValueError)


@pytest.mark.parametrize("value", ["", "a", "acgt", "t" * 32, "RYN", "uu"])
def test_length_equality_and_hash(value):
    for port, ref in TYPES:
        try:
            want = jax_length(ref(value))
        except jerrors.KmerEngineError:
            continue
        a, b = port(value), port(value.upper())
        assert length(a) == want
        assert a == b and hash(a) == hash(b) and a == value
        assert repr(a) == repr(ref(value))


def test_kmer_keys_and_leading_codes():
    for s in ["", "a", "acgt", "t" * 16, "t" * 17, "gattaca" * 4, "t" * 32]:
        km, jk = Kmer(s), JKmer(s)
        assert km.key64 == jk.key64 and km.hi_lo == jk.hi_lo
        assert str(Kmer.from_key64(km.key64, len(s))) == s
    for q in ["", "acgn", "nacg", "acgt", "u", "acgtacgtacgtacgtacgtacgtacgtacgt"]:
        np.testing.assert_array_equal(Qkmer(q).leading_exact_codes(),
                                      JQkmer(q).leading_exact_codes())


def test_codec_tables_and_helpers():
    np.testing.assert_array_equal(codec.MASK_LUT, jcodec.MASK_LUT)
    np.testing.assert_array_equal(codec.MASK_TO_CHAR, jcodec.MASK_TO_CHAR)
    assert codec.IUPAC_MASKS == jcodec.IUPAC_MASKS
    for q in ["", "angry", "RYKMSWBDHVNU"]:
        m = codec.encode_qkmer(q)
        np.testing.assert_array_equal(m, jcodec.encode_qkmer(q))
        assert codec.decode_masks(m) == jcodec.decode_masks(m)
    for m in range(16):
        assert codec.is_exact_mask(m) == jcodec.is_exact_mask(m)
        if jcodec.is_exact_mask(m):
            assert codec.exact_mask_to_code(m) == jcodec.exact_mask_to_code(m)
    seqs = ["", "a", "acgt", "t" * 32, "gattaca"]
    got = codec.strings_to_padded_codes(seqs, encoder=codec.encode_kmer)
    want = jcodec.strings_to_padded_codes(seqs, encoder=jcodec.encode_kmer)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(codec.pack_batch(*got), jcodec.pack_batch(*want)):
        np.testing.assert_array_equal(g, w)
    key = codec.pack_key64(codec.encode_kmer("t" * 32))
    assert key == jcodec.pack_key64(jcodec.encode_kmer("t" * 32))
    assert codec.split_key64(key) == jcodec.split_key64(key)


def _lanes(p):
    return [np.asarray(a) for a in (p.hi, p.lo, p.length)]


def test_packed_constructors_match_kmer_tpu():
    rng = np.random.default_rng(7)
    strs = ["", "t" * 32, "a" * 32, "t"] + [
        "".join("acgt"[c] for c in rng.integers(0, 4, rng.integers(0, 33)))
        for _ in range(200)]
    port, ref = PackedKmers.from_strings(strs), JaxPacked.from_strings(strs)
    for g, w in zip(_lanes(port), _lanes(ref)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(port) == len(ref) == len(strs)
    assert port.to_strings() == strs
    kms = [Kmer(s) for s in strs[:20]]
    for g, w in zip(_lanes(PackedKmers.from_kmers(kms)),
                    _lanes(JaxPacked.from_kmers([JKmer(s) for s in strs[:20]]))):
        np.testing.assert_array_equal(g, w)
    one = PackedKmers.single(Kmer("acga"))
    assert one.to_strings() == ["acga"] and len(one) == 1
    assert [str(k) for k in port[:5].to_kmers()] == strs[:5]
    np.testing.assert_array_equal(port.key64(), ref.key64())
    both = concat([port[:3], port[3:]])
    ref_both = jax_concat([ref[:3], ref[3:]])
    for g, w in zip(_lanes(both), _lanes(ref_both)):
        np.testing.assert_array_equal(g, w)
    col = KmerColumn.from_packed(port, "cpu")
    assert len(col) == len(strs) and len(col[0]) == 1
    np.testing.assert_array_equal(col.key.numpy().view(np.uint64),
                                  ref.key64())
    np.testing.assert_array_equal(col.length.numpy(), ref.length)


def test_kmer_too_long_from_codes():
    with pytest.raises(errors.KmerTooLongError):
        Kmer(np.zeros(33, np.uint8))
    with pytest.raises(errors.KmerTooLongError):
        PackedKmers.from_strings(["a" * 33])


@pytest.mark.parametrize("dna, k", [
    ("ACGTACGT", 3), ("ACGTACGT", 8), ("ACGTACGT", 1), ("acgt" * 10, 32),
    ("T" * 40, 17), ("ACGT", 0), ("AC", 5), ("acgt" * 10, 33), ("", 1),
    ("ACGTN", 2), ("ACGT", -1)])
def test_generate_kmers_matches_kmer_tpu(dna, k):
    def run(fn):
        try:
            return fn(dna, k)
        except (jerrors.KmerEngineError, errors.KmerEngineError) as e:
            return type(e).__name__, str(e)

    assert run(extract_to_strings) == run(jax_extract)
    if isinstance(run(jax_extract), list):
        assert [str(km) for km in generate_kmers(dna, k)] == run(jax_extract)


@pytest.mark.parametrize("n, seed", [(0, 0), (1, 3), (500, 14), (2000, 100)])
def test_datagen_rows_match_kmer_tpu(n, seed, tmp_path):
    rows = generate_test_rows(n, seed=seed)
    assert rows == jax_rows(n, seed=seed)
    rows_to_csv(rows, str(tmp_path / "port.csv"))
    jax_rows_to_csv(rows, str(tmp_path / "jax.csv"))
    assert ((tmp_path / "port.csv").read_bytes()
            == (tmp_path / "jax.csv").read_bytes())
