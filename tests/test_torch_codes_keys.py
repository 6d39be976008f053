"""The port's codes -> keys step (``kernels/codes_keys``) and word stream
-> keys step (``kernels/wire_keys.stream_keys``), on the CPU their plain
versions, vs kmer_tpu's extract + canonicalize bit for bit (int64 keys
split to kmer_tpu's hi/lo lanes), in every slot, valid or not; and the
count paths that reach them.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from kmer_tpu.errors import InvalidKmerLengthError as JaxInvalidKmerLength
from kmer_tpu.native import pack2bit_rows
from kmer_tpu.ops import extract as jx
from kmer_tpu.parallel.dist import _extract_with_halo as jax_halo
from kmer_tpu.parallel.dist import _shard_map
from kmer_tpu.parallel.mesh import make_mesh as jax_mesh
from kmer_tpu_torch.errors import InvalidKmerLengthError
from kmer_tpu_torch.kernels import codes_keys as ck
from kmer_tpu_torch.kernels import wire_keys as wk
from kmer_tpu_torch.kernels.codes_keys import (
    as_codes, codes_keys, codes_keys_reference)
from kmer_tpu_torch.kernels.wire_keys import stream_keys, stream_keys_reference
from kmer_tpu_torch.packed import hi_lo_from_key
from kernel_edges import (
    CODES_KS, CODES_WIDTHS, STREAM_CASES, STREAM_KS, codes_case, codes_shape,
    stream_case)


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_both(codes, lengths, k):
    """kmer_tpu: extract_windows_batch, then canonicalize, in one compile
    -> (hi, lo, canonical hi, canonical lo, valid)."""
    packed, valid = jx.extract_windows_batch(codes, lengths, k)
    return (packed.hi, packed.lo, *jx.canonicalize(packed.hi, packed.lo, k),
            valid)


def _jax(codes, lengths, k, canonical):
    """kmer_tpu: extract_windows_batch (+ canonicalize) -> (hi, lo, valid)."""
    out = [np.asarray(x) for x in _jax_both(jnp.asarray(codes),
                                            jnp.asarray(lengths), k)]
    return (*out[2:4], out[4]) if canonical else (*out[:2], out[4])


def _assert_keys(keys, hi, lo):
    ghi, glo = hi_lo_from_key(keys.numpy())
    np.testing.assert_array_equal(ghi, hi)
    np.testing.assert_array_equal(glo, lo)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("width", CODES_WIDTHS)
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", CODES_KS)
def test_codes_keys_bit_identical(k, canonical, width):
    """Rows of length 0, below k, equal to L, t-leading and all-t; widths
    of whole 16-byte chunks and not.  k above the width raises in both."""
    codes, lengths = codes_case(width, k)
    if k > width:
        with pytest.raises(JaxInvalidKmerLength, match="Invalid KMER Length"):
            jx.extract_windows_batch(jnp.asarray(codes), jnp.asarray(lengths),
                                     k)
        with pytest.raises(InvalidKmerLengthError,
                           match="Invalid KMER Length"):
            codes_keys(_t(codes), _t(lengths), k, canonical)
        return
    hi, lo, want_valid = _jax(codes, lengths, k, canonical)
    keys, valid = codes_keys(_t(codes), _t(lengths), k, canonical)
    assert keys.dtype == torch.int64 and valid.dtype == torch.bool
    assert keys.shape == valid.shape == (codes.shape[0], width - k + 1)
    _assert_keys(keys, hi, lo)
    np.testing.assert_array_equal(valid.numpy(), want_valid)


@pytest.mark.parametrize("canonical", [False, True])
def test_codes_keys_row_longer_than_2_16(canonical):
    """count_dna's form: one row of 69,857 bases (the kernel tiles it over
    many blocks), int32 and int64 lengths."""
    codes, lengths, k = codes_shape("long_row")
    hi, lo, want_valid = _jax(codes, lengths, k, canonical)
    for lens in (lengths, lengths.astype(np.int64)):
        keys, valid = codes_keys(_t(codes), _t(lens), k, canonical)
        _assert_keys(keys, hi, lo)
        np.testing.assert_array_equal(valid.numpy(), want_valid)


@pytest.mark.parametrize("k", [1, 9, 21, 32])
def test_codes_keys_on_halo_blocks(k):
    """``_extract_with_halo``'s blocks on a (1, 2) seq split: each rank's
    columns, the ring's next rank's first k - 1 (zeros on one rank) and
    the lengths clamped by ``_local_lengths``, through codes_keys, equal
    kmer_tpu's halo windows and valid mask; and the port's
    ``_extract_with_halo`` on a (1, 1) mesh equals kmer_tpu's there."""
    from kmer_tpu_torch.parallel.dist import _extract_with_halo, _local_lengths
    from kmer_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (16, 160), dtype=np.uint8)
    codes[::4, 0] = 3
    lengths = rng.integers(0, 161, 16).astype(np.int32)
    lengths[:3] = 0, 160, 81
    for seq in (1, 2):
        mesh = jax_mesh((1, seq), jax.devices()[:seq])
        f = jax.jit(_shard_map(
            lambda c, ln: jax_halo(c, ln, k, seq, True), mesh,
            in_specs=(P("data", "seq"), P("data")),
            out_specs=(P("data", "seq"),) * 3))
        hi, lo, valid = (np.asarray(x) for x in f(jnp.asarray(codes),
                                                  jnp.asarray(lengths)))
        l_loc = 160 // seq
        for s in range(seq):
            block = codes[:, s * l_loc: (s + 1) * l_loc]
            t = (s + 1) % seq * l_loc  # the ring's next rank (zeros alone)
            nxt = (codes[:, t: t + k - 1] if seq > 1
                   else np.zeros((16, k - 1), np.uint8))
            ext = np.concatenate([block, nxt], axis=1)
            lens = _local_lengths(_t(lengths),
                                  types.SimpleNamespace(coords=(0, s)),
                                  l_loc, k)
            keys, ok = codes_keys(_t(ext), lens, k, True)
            at = slice(s * l_loc, (s + 1) * l_loc)
            _assert_keys(keys, hi[:, at], lo[:, at])
            np.testing.assert_array_equal(ok.numpy(), valid[:, at])
        if seq == 1:
            keys, ok = _extract_with_halo(_t(codes), _t(lengths), k,
                                          make_mesh((1, 1), device="cpu"),
                                          True)
            _assert_keys(keys, hi, lo)
            np.testing.assert_array_equal(ok.numpy(), valid)


def test_codes_keys_into_views_and_empty_batch():
    """keys_out / valid_out views of flat buffers; B = 0 gives [0, m]."""
    codes, lengths = codes_case(150, 21)
    want, want_valid = codes_keys_reference(_t(codes), _t(lengths), 21, True)
    flat = torch.full((12 * 130 + 1,), -7, dtype=torch.int64)
    vflat = torch.zeros(12 * 130 + 1, dtype=torch.bool)
    keys, valid = codes_keys(_t(codes), _t(lengths), 21, True,
                             keys_out=flat[1:].view(12, 130),
                             valid_out=vflat[1:].view(12, 130))
    assert keys.data_ptr() == flat[1:].data_ptr()
    assert torch.equal(keys, want) and torch.equal(valid, want_valid)
    assert int(flat[0]) == -7
    empty, ok = codes_keys(torch.zeros((0, 150), dtype=torch.uint8),
                           torch.zeros(0, dtype=torch.int32), 21, False)
    assert empty.shape == ok.shape == (0, 130)


@pytest.mark.parametrize("k", [0, 33, 151])
def test_codes_keys_invalid_k_raises(k):
    codes, lengths = codes_case(150, 21)
    with pytest.raises(InvalidKmerLengthError, match="Invalid KMER Length"):
        codes_keys(_t(codes), _t(lengths), k, True)


def test_codes_keys_takes_uint8_codes_only():
    """Codes of another dtype raise TypeError (never the plain version);
    the count paths cast once (``as_codes``), with the same keys."""
    codes, lengths = codes_case(150, 21)
    for dtype in (torch.int64, torch.int32, torch.int8):
        other = _t(codes).to(dtype)
        with pytest.raises(TypeError, match="uint8"):
            codes_keys(other, _t(lengths), 21, True)
        cast = as_codes(other)
        assert cast.dtype == torch.uint8 and torch.equal(cast, _t(codes))
    from kmer_tpu_torch.ops.count import count_kmers

    a = count_kmers(_t(codes).to(torch.int64), _t(lengths), 21, True)
    b = count_kmers(_t(codes), _t(lengths), 21, True)
    assert a.to_dict() == b.to_dict()


def test_codes_keys_rejects_what_the_kernel_does_not_take():
    codes, lengths = codes_case(150, 21)
    c, ln = _t(codes), _t(lengths)
    with pytest.raises(ValueError, match="contiguous"):
        codes_keys(c.t().contiguous().t(), ln, 21, True)
    with pytest.raises(ValueError, match=r"\[B, L\]"):
        codes_keys(c.reshape(-1), ln, 21, True)
    with pytest.raises(ValueError, match="lengths"):
        codes_keys(c, ln[:5], 21, True)
    with pytest.raises(ValueError, match="lengths"):
        codes_keys(c, ln.to(torch.float32), 21, True)
    with pytest.raises(ValueError, match="keys_out"):
        codes_keys(c, ln, 21, True, keys_out=torch.empty((12, 129),
                                                         dtype=torch.int64))


def test_cpu_wrappers_launch_nothing():
    codes, lengths = codes_case(150, 21)
    words = pack2bit_rows(stream_case(5, 150)[None, :])[0]
    before = codes_keys.launches, stream_keys.launches
    codes_keys(_t(codes), _t(lengths), 21, True)
    stream_keys(_t(words.view(np.int32)), 21, True, 150, 5)
    assert (codes_keys.launches, stream_keys.launches) == before


# --- stream_keys ------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_words(words, k):
    """kmer_tpu: extract_from_words, then canonicalize, in one compile."""
    hi, lo = jx.extract_from_words(words, k)
    return (hi, lo, *jx.canonicalize(hi, lo, k))


# kmer_tpu's lanes split at 16 bases; every k of STREAM_KS runs in the
# numpy model of the kernel (tests/test_torch_probe_kernels.py)
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 16, 17, 21, 32])
@pytest.mark.parametrize("n_reads, read_len",
                         [(3, 16), (55, 150), (7, 161), (1, 16 * 1024 + 16)])
def test_stream_keys_bit_identical(n_reads, read_len, k, canonical):
    """extract_from_words (+ canonicalize) and phase_major_valid of
    kmer_tpu, every slot of the 16 phase rows, tail windows included, for
    read lengths that divide 16 and not; uint32 words too."""
    assert (n_reads, read_len) in STREAM_CASES and k in STREAM_KS
    words = pack2bit_rows(stream_case(n_reads, read_len)[None, :])[0]
    lanes = [np.asarray(x) for x in _jax_words(jnp.asarray(words), k)]
    hi, lo = lanes[2:] if canonical else lanes[:2]
    want_valid = np.asarray(jx.phase_major_valid(words.size, read_len,
                                                 n_reads, k))
    for t in (_t(words.view(np.int32)), _t(words.view(np.int32)).view(
            torch.uint32)):
        keys, valid = stream_keys(t, k, canonical, read_len, n_reads)
        assert keys.shape == valid.shape == (16, words.size)
        _assert_keys(keys, hi, lo)
        np.testing.assert_array_equal(valid.numpy(), want_valid)


def test_stream_keys_rejects_what_the_kernel_does_not_take():
    words = _t(pack2bit_rows(stream_case(5, 150)[None, :])[0].view(np.int32))
    for k in (0, 33):
        with pytest.raises(InvalidKmerLengthError,
                           match="Invalid KMER Length"):
            stream_keys(words, k, True, 150, 5)
    with pytest.raises(TypeError, match="32-bit"):
        stream_keys(words.to(torch.int64), 21, True, 150, 5)
    with pytest.raises(ValueError, match="1-D"):
        stream_keys(words.view(1, -1), 21, True, 150, 5)
    with pytest.raises(ValueError, match="read_len"):
        stream_keys(words, 21, True, 0, 5)
    keys, valid = stream_keys(words[:0], 21, True, 150, 0)
    assert keys.shape == valid.shape == (16, 0)


# --- the paths that reach the kernels --------------------------------------


@pytest.fixture
def spies(monkeypatch):
    """codes_keys and stream_keys wrapped in counting spies wherever the
    count paths imported them; returns the calls by name."""
    import kmer_tpu_torch.bench as bench
    import kmer_tpu_torch.ops.count as count
    import kmer_tpu_torch.ops.dense_count as dense
    import kmer_tpu_torch.parallel.dist as dist
    import kmer_tpu_torch.probes.partition as partition

    calls = {"codes_keys": 0, "stream_keys": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for mod in (count, dense, dist):
        monkeypatch.setattr(mod, "codes_keys",
                            spy("codes_keys", ck.codes_keys))
    for mod in (bench, partition):
        monkeypatch.setattr(mod, "stream_keys",
                            spy("stream_keys", wk.stream_keys))
    return calls


def test_count_paths_reach_the_kernels(spies):
    """count_kmers, count_dna, count_kmers_auto (both routes),
    count_kmers_dense, KmerCounter (both routes, and count_sharded),
    count_kmers_sharded, the sharded stream fed codes, the bench's stream
    and chr modes and the partition probe's lanes each make their keys in
    one call of their kernel's wrapper."""
    from kmer_tpu_torch.bench import run_bench_stream, run_chr_bench
    from kmer_tpu_torch.config import EngineConfig
    from kmer_tpu_torch.models import KmerCounter
    from kmer_tpu_torch.ops import count_kmers_auto
    from kmer_tpu_torch.ops.count import count_dna, count_kmers
    from kmer_tpu_torch.ops.dense_count import count_kmers_dense
    from kmer_tpu_torch.parallel.dist import count_kmers_sharded
    from kmer_tpu_torch.parallel.mesh import make_mesh
    from kmer_tpu_torch.parallel.streaming import (
        batches_of, stream_sharded_count)
    from kmer_tpu_torch.probes.partition import make_lanes

    codes, lengths = codes_case(64, 21, rows=8)
    c, ln = _t(codes), _t(lengths)
    mesh = make_mesh((1, 1), device="cpu")

    def one(fn, name="codes_keys", calls=1):
        before = dict(spies)
        fn()
        assert spies[name] == before[name] + calls, fn
        other = "stream_keys" if name == "codes_keys" else "codes_keys"
        assert spies[other] == before[other]

    one(lambda: count_kmers(c, ln, 21, True))
    one(lambda: count_dna("ACGT" * 20, 9, True, device="cpu"))
    one(lambda: count_kmers_auto(c, ln, 21, True))
    one(lambda: count_kmers_auto(c, ln, 5, True))
    one(lambda: count_kmers_dense(c, ln, 4, False))
    for k in (5, 21):
        counter = KmerCounter(EngineConfig(k=k, canonical=True),
                              device="cpu")
        one(lambda: counter.step(codes, lengths))
    one(lambda: KmerCounter(EngineConfig(k=21, canonical=True),
                            device="cpu").count_sharded(codes, lengths, mesh))
    one(lambda: count_kmers_sharded(codes, lengths, 21, mesh, True,
                                    "partition"))
    before = spies["codes_keys"]
    stream_sharded_count(batches_of(codes, lengths, 4), 21, mesh,
                         canonical=True, acc_capacity=1024)
    assert spies["codes_keys"] == before + 2  # one a batch
    # the bench's two runs: the warm call and the timed one
    one(lambda: run_bench_stream(n_reads=32, device="cpu"), "stream_keys", 2)
    one(lambda: run_chr_bench(n_bases=4096, device="cpu"), "stream_keys", 2)
    one(lambda: make_lanes.__wrapped__(False, torch.device("cpu"), True),
        "stream_keys")
