"""The port's unpack, extraction, reverse complement and canonicalization
vs kmer_tpu's, bit for bit (int64 keys split to kmer_tpu's hi/lo lanes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu.native import device_unpack_rows as jax_unpack
from kmer_tpu.native import pack2bit_rows
from kmer_tpu.ops import extract as jx
from kmer_tpu_torch.errors import InvalidKmerLengthError
from kmer_tpu_torch.native import device_unpack_rows
from kmer_tpu_torch.native import pack2bit_rows as native_pack2bit_rows
from kmer_tpu_torch.ops import extract as tx
from kmer_tpu_torch.packed import hi_lo_from_key, key_from_hi_lo

KS = [1, 15, 16, 17, 21, 23, 24, 31, 32]


def _reads(seed=0, b=24, width=48):
    """Padded code rows with random lengths; some rows start with t, one is
    all t (keys with the top bit set, and the all-ones 32-mer)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, width)).astype(np.uint8)
    codes[::3, 0] = 3
    codes[1, :] = 3
    lengths = rng.integers(0, width + 1, size=b).astype(np.int32)
    lengths[1] = width
    return codes, lengths


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_extract_bit_identical(k, canonical):
    codes, lengths = _reads(seed=k)
    want, want_valid = jx.extract_windows_batch(jnp.asarray(codes),
                                                jnp.asarray(lengths), k)
    whi, wlo = want.hi, want.lo
    if canonical:
        whi, wlo = jx.canonicalize(whi, wlo, k)
    keys, valid = tx.extract_windows_batch(torch.from_numpy(codes),
                                           torch.from_numpy(lengths), k)
    if canonical:
        keys = tx.canonicalize(keys, k)
    hi, lo = hi_lo_from_key(keys.numpy())
    np.testing.assert_array_equal(hi, np.asarray(whi))
    np.testing.assert_array_equal(lo, np.asarray(wlo))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))


@pytest.mark.parametrize("k", KS)
def test_revcomp_bit_identical(k):
    rng = np.random.default_rng(100 + k)
    hi = rng.integers(0, 1 << 32, 4000, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 4000, dtype=np.uint64).astype(np.uint32)
    # left-aligned keys of length k: zero the padding bits
    key = key_from_hi_lo(hi, lo).view(np.uint64)
    key &= ~np.uint64((1 << (64 - 2 * k)) - 1) if k < 32 else ~np.uint64(0)
    hi, lo = hi_lo_from_key(key.view(np.int64))
    rh, rl = jx.revcomp_packed(jnp.asarray(hi), jnp.asarray(lo), k)
    got = tx.revcomp_packed(torch.from_numpy(key.view(np.int64).copy()), k)
    ghi, glo = hi_lo_from_key(got.numpy())
    np.testing.assert_array_equal(ghi, np.asarray(rh))
    np.testing.assert_array_equal(glo, np.asarray(rl))


def test_device_unpack_matches():
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=(16, 160)).astype(np.uint8)
    codes[:, 0] = 3  # bit 31 of every first word
    words = pack2bit_rows(codes)
    want = np.asarray(jax_unpack(jnp.asarray(words), 160))
    wire = torch.from_numpy(words.view(np.int32)).to(torch.int64) & 0xFFFFFFFF
    got = device_unpack_rows(wire, 160)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), codes)


@pytest.mark.parametrize("k", [0, 33, 49])
def test_invalid_k_raises(k):
    codes, lengths = _reads(width=48)
    with pytest.raises(InvalidKmerLengthError, match="Invalid KMER Length"):
        tx.extract_windows_batch(torch.from_numpy(codes),
                                 torch.from_numpy(lengths), k)


def test_simulated_reads_match_kmer_tpu():
    np.testing.assert_array_equal(tx.simulate_reads(50, 30, seed=3),
                                  jx.simulate_reads(50, 30, seed=3))
    np.testing.assert_array_equal(
        tx.simulate_coverage_reads(50, 30, 500, seed=3),
        jx.simulate_coverage_reads(50, 30, 500, seed=3))


KS_WORDS = [1, 15, 16, 17, 21, 31, 32]


def _word_stream(seed, n_bases=16 * 37):
    """A packed base stream (uint32 words) with a t-leading word and an
    all-t tail, so keys with bit 63 set and all-ones keys occur."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(1, n_bases)).astype(np.uint8)
    codes[0, 16] = 3
    codes[0, -40:] = 3
    return codes, pack2bit_rows(codes)[0]


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS_WORDS)
def test_extract_from_words_bit_identical(k, canonical):
    codes, words = _word_stream(200 + k)
    whi, wlo = jx.extract_from_words(jnp.asarray(words), k)
    if canonical:
        whi, wlo = jx.canonicalize(whi, wlo, k)
    # int32 bits, as the bench uploads them; the tail windows read zeros
    keys = tx.extract_from_words(torch.from_numpy(words.view(np.int32)), k)
    if canonical:
        keys = tx.canonicalize(keys, k)
    assert keys.shape == (16, words.size)
    hi, lo = hi_lo_from_key(keys.numpy())
    np.testing.assert_array_equal(hi, np.asarray(whi))
    np.testing.assert_array_equal(lo, np.asarray(wlo))


@pytest.mark.parametrize("k", KS_WORDS)
def test_phase_major_valid_matches(k):
    read_len, n_reads = 48, 12  # 576 bases = 36 words
    want = jx.phase_major_valid(36, read_len, n_reads, k)
    got = tx.phase_major_valid(36, read_len, n_reads, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", KS_WORDS)
def test_extract_windows_bit_identical(k):
    codes, words = _word_stream(300 + k, n_bases=200)
    whi, wlo = jx.extract_windows(jnp.asarray(codes[0]), k)
    keys = tx.extract_windows(torch.from_numpy(codes[0]), k)
    hi, lo = hi_lo_from_key(keys.numpy())
    np.testing.assert_array_equal(hi, np.asarray(whi))
    np.testing.assert_array_equal(lo, np.asarray(wlo))
    # the phase-major form holds the same windows, slot p = 16w + r
    pm = tx.extract_from_words(torch.from_numpy(words.view(np.int32)), k)
    flat = pm.t().reshape(-1)[: keys.numel()]
    np.testing.assert_array_equal(flat.numpy(), keys.numpy())


def test_pack2bit_rows_matches_kmer_tpu():
    rng = np.random.default_rng(8)
    for width in (1, 16, 150, 161):
        codes = rng.integers(0, 4, size=(5, width)).astype(np.uint8)
        np.testing.assert_array_equal(native_pack2bit_rows(codes),
                                      pack2bit_rows(codes))


@pytest.mark.parametrize("k", [0, 33])
def test_words_invalid_k_raises(k):
    with pytest.raises(InvalidKmerLengthError, match="Invalid KMER Length"):
        tx.extract_from_words(torch.zeros(4, dtype=torch.int32), k)
