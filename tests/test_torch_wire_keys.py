"""The port's wire -> keys step (``kernels/wire_keys``, on the CPU its plain
version) vs kmer_tpu's unpack + extract + canonicalize, bit for bit (int64
keys split to kmer_tpu's hi/lo lanes), in every slot, valid or not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu.errors import InvalidKmerLengthError as JaxInvalidKmerLength
from kmer_tpu.native import device_unpack_rows as jax_unpack
from kmer_tpu.native import pack2bit_rows
from kmer_tpu.ops import extract as jx
from kmer_tpu_torch.errors import InvalidKmerLengthError
from kmer_tpu_torch.kernels.wire_keys import wire_keys, wire_keys_reference
from kmer_tpu_torch.packed import hi_lo_from_key
from kernel_edges import WIRE_KS, WIRE_WIDTHS, wire_case


def _wire(codes, lengths=None):
    """kmer_tpu's packed words, plus the length column when given, as the
    int32 bits the pipeline uploads."""
    words = pack2bit_rows(codes)
    if lengths is not None:
        words = np.concatenate([words, lengths[:, None]], axis=1)
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _jax(codes, lengths, k, canonical):
    """kmer_tpu: device_unpack_rows + extract_windows_batch (+
    canonicalize) on the packed words -> (hi, lo, valid)."""
    width = codes.shape[1]
    unpacked = jax_unpack(jnp.asarray(pack2bit_rows(codes)), width)
    packed, valid = jx.extract_windows_batch(unpacked, jnp.asarray(lengths), k)
    hi, lo = packed.hi, packed.lo
    if canonical:
        hi, lo = jx.canonicalize(hi, lo, k)
    return np.asarray(hi), np.asarray(lo), np.asarray(valid)


def _assert_keys(keys, hi, lo):
    ghi, glo = hi_lo_from_key(keys.numpy())
    np.testing.assert_array_equal(ghi, hi)
    np.testing.assert_array_equal(glo, lo)


@pytest.mark.parametrize("width", WIRE_WIDTHS)
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", WIRE_KS)
def test_wire_keys_bit_identical(k, canonical, width):
    """Rows of length 0, below k, equal to the width, t-leading and all-t;
    widths of whole words and not.  k above the width raises in both."""
    codes, lengths = wire_case(width, k)
    wire = _wire(codes, lengths)
    if k > width:
        with pytest.raises(JaxInvalidKmerLength, match="Invalid KMER Length"):
            jx.extract_windows_batch(jnp.asarray(codes), jnp.asarray(lengths),
                                     k)
        with pytest.raises(InvalidKmerLengthError,
                           match="Invalid KMER Length"):
            wire_keys(wire, width, k, canonical)
        return
    hi, lo, want_valid = _jax(codes, lengths, k, canonical)
    keys, valid = wire_keys(wire, width, k, canonical)
    assert keys.dtype == torch.int64 and valid.dtype == torch.bool
    assert keys.shape == valid.shape == (codes.shape[0], width - k + 1)
    _assert_keys(keys, hi, lo)
    np.testing.assert_array_equal(valid.numpy(), want_valid)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 16, 21, 32])
def test_wire_keys_lengths_free(k, canonical):
    """The bench's form: no length column, no mask; every row full."""
    codes, _ = wire_case(150, k)
    full = np.full(codes.shape[0], 150, np.uint32)
    hi, lo, _ = _jax(codes, full, k, canonical)
    keys, valid = wire_keys(_wire(codes), 150, k, canonical, lengths=False)
    assert valid is None
    _assert_keys(keys, hi, lo)


@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("k", [15, 21, 32])
def test_wire_keys_into_flat_buffer_views(k, first):
    """Batch i writes slots [i * spb, (i + 1) * spb) of one flat buffer
    through [B, m] views (an odd start too), as count_long_sequence does;
    nothing outside the views changes."""
    width, b = 48, 12
    m = width - k + 1
    spb = b * m
    keys = torch.full((first + 2 * spb + 1,), -7, dtype=torch.int64)
    valid = torch.ones(first + 2 * spb + 1, dtype=torch.bool)
    want = []
    for i in range(2):
        codes, lengths = wire_case(width, k, rows=b, seed=i)
        at = slice(first + i * spb, first + (i + 1) * spb)
        got = wire_keys(_wire(codes, lengths), width, k, True,
                        keys_out=keys[at].view(b, m),
                        valid_out=valid[at].view(b, m))
        assert got[0].data_ptr() == keys[at].data_ptr()
        want.append(_jax(codes, lengths, k, True))
    hi, lo, want_valid = (np.concatenate([w[j].reshape(-1) for w in want])
                          for j in range(3))
    inside = slice(first, first + 2 * spb)
    _assert_keys(keys[inside], hi, lo)
    np.testing.assert_array_equal(valid[inside].numpy(), want_valid)
    assert int(keys[-1]) == -7 and bool(valid[-1])
    assert first == 0 or (int(keys[0]) == -7 and bool(valid[0]))


@pytest.mark.parametrize("k", [0, 33, 49])
def test_wire_keys_invalid_k_raises(k):
    codes, lengths = wire_case(48, 21)
    with pytest.raises(InvalidKmerLengthError, match="Invalid KMER Length"):
        wire_keys(_wire(codes, lengths), 48, k, True)
    with pytest.raises(InvalidKmerLengthError, match="Invalid KMER Length"):
        wire_keys_reference(_wire(codes, lengths), 48, k, True)


def test_wire_keys_rejects_what_the_kernel_does_not_take():
    codes, lengths = wire_case(48, 21)
    wire = _wire(codes, lengths)
    with pytest.raises(ValueError, match="base words"):
        wire_keys(wire, 64, 21, True)  # 4 base words + a length, not 3 + 1
    with pytest.raises(ValueError, match="base words"):
        wire_keys(wire, 48, 21, True, lengths=False)
    with pytest.raises(TypeError, match="int32"):
        wire_keys(wire.to(torch.int64), 48, 21, True)
    with pytest.raises(ValueError, match="keys_out"):
        wire_keys(wire, 48, 21, True,
                  keys_out=torch.empty(12, 27, dtype=torch.int64))
    with pytest.raises(ValueError, match="length column"):
        wire_keys(_wire(codes), 48, 21, True, lengths=False,
                  valid_out=torch.empty(12, 28, dtype=torch.bool))


def test_wire_keys_cpu_launches_nothing():
    codes, lengths = wire_case(48, 21)
    before = wire_keys.launches
    wire_keys(_wire(codes, lengths), 48, 21, True)
    assert wire_keys.launches == before
