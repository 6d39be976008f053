"""The port's EngineConfig, KmerCounter and graft entry against
kmer_tpu's (JAX on the CPU), on the same seeded numpy reads.

Trimmed tables (hi, lo, length, counts) and n_unique are compared
exactly, and so are validation errors (class and message).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from kmer_tpu.config import EngineConfig as JaxConfig
from kmer_tpu.models import KmerCounter as JaxCounter
from kmer_tpu.ops.count import merge_tables as jax_merge
from kmer_tpu.ops.extract import simulate_reads
from kmer_tpu_torch import graft_entry
from kmer_tpu_torch.config import EngineConfig
from kmer_tpu_torch.errors import InvalidKmerLengthError
from kmer_tpu_torch.models import KmerCounter
from kmer_tpu_torch.ops.count import merge_tables
from kmer_tpu_torch.ops.dense_count import DENSE_EXACT_LIMIT

REPO = Path(__file__).resolve().parents[1]


def _trimmed(t):
    """(hi, lo, length, counts) of a trimmed table of either package."""
    if hasattr(t, "hi"):
        t = t.trim()
        return (np.asarray(t.hi), np.asarray(t.lo), np.asarray(t.length),
                np.asarray(t.counts))
    return t.trim().to_numpy()


def _assert_same(got, want):
    for name, g, w in zip(("hi", "lo", "length", "counts"), _trimmed(got),
                          _trimmed(want)):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.distinct() == int(want.n_unique)


# --- EngineConfig -----------------------------------------------------------


def test_config_fields_and_defaults_match_kmer_tpu():
    fields = [(f.name, f.default) for f in dataclasses.fields(EngineConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(JaxConfig)]
    assert dataclasses.asdict(EngineConfig()) == dataclasses.asdict(
        JaxConfig())


@pytest.mark.parametrize("k", [0, -1, 33, 100])
def test_config_rejects_k_like_kmer_tpu(k):
    with pytest.raises(InvalidKmerLengthError) as got:
        EngineConfig(k=k)
    with pytest.raises(Exception) as want:
        JaxConfig(k=k)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value) == "Invalid KMER Length"


@pytest.mark.parametrize("k, read_len", [(1, 150), (21, 150), (32, 32),
                                         (8, 64)])
def test_windows_per_read(k, read_len):
    assert EngineConfig(k=k, read_len=read_len).windows_per_read() == \
        JaxConfig(k=k, read_len=read_len).windows_per_read()


def test_activate_returns_self_or_refuses_the_plain_route():
    cfg = EngineConfig(k=11)
    assert cfg.activate() is cfg
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 2"):
        EngineConfig(use_pallas=False).activate()


# --- KmerCounter ------------------------------------------------------------


def _batches(seed, n_steps=3, n=16, width=40):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_steps):
        reads = simulate_reads(n, width, seed=seed * 10 + s)
        lengths = rng.integers(0, width + 1, n).astype(np.int32)
        reads[0] = 3  # all-t
        out.append((reads, lengths))
    return out


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [5, 6, 7, 11, 21, 32])
def test_counter_steps_match_kmer_tpu(k, canonical):
    cfg = dict(k=k, canonical=canonical)
    port = KmerCounter(EngineConfig(**cfg), device="cpu")
    ref = JaxCounter(JaxConfig(**cfg))
    got_all = want_all = None
    for i, (reads, lengths) in enumerate(_batches(k + 2 * canonical)):
        # numpy in, and tensors in: both land on the counter's device
        args = (reads, lengths) if i % 2 == 0 else (
            torch.from_numpy(reads), torch.from_numpy(lengths))
        got = port.step(*args)
        want = ref.step(reads, lengths)
        _assert_same(got, want)
        got_all = got if got_all is None else merge_tables(got_all, got)
        want_all = want if want_all is None else jax_merge(want_all, want)
    _assert_same(got_all, want_all)
    port.check_exact()
    ref.check_exact()


def test_dense_route_runs_at_and_below_route_k():
    reads, lengths = _batches(3, n_steps=1)[0]
    for k, dense in ((6, True), (7, False)):
        table = KmerCounter(EngineConfig(k=k), device="cpu").step(
            reads, lengths)
        # the dense route keeps every bin, the sort route every window slot
        assert (table.capacity == 4 ** k) == dense


def test_check_exact_reads_the_running_bin_max():
    counter = KmerCounter(EngineConfig(k=4), device="cpu")
    counter.check_exact()  # no step yet: nothing to check
    reads, lengths = _batches(4, n_steps=1)[0]
    counter.step(reads, lengths)
    assert counter._dense_max.device.type == "cpu"
    counter.check_exact()
    counter._dense_max = torch.tensor(DENSE_EXACT_LIMIT, dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        counter.check_exact()
    # the sort route tracks nothing
    sort = KmerCounter(EngineConfig(k=21), device="cpu")
    sort.step(reads, lengths)
    assert sort._dense_max is None
    sort.check_exact()


@pytest.mark.parametrize("method", ["sharded_step", "count_sharded"])
def test_multi_device_steps_match_kmer_tpu_on_one_rank(method):
    """On the default mesh, one rank without a process group, the
    multi-device steps count as kmer_tpu's do on a one-device mesh."""
    import jax

    from kmer_tpu.parallel.mesh import make_mesh

    codes = simulate_reads(num_reads=8, read_len=30, seed=3)
    lengths = np.full(8, 30, np.int32)
    lengths[0] = 11
    counter = KmerCounter(EngineConfig(), device="cpu")
    if method == "sharded_step":
        got = counter.sharded_step()(codes, lengths)
        assert counter.sharded_step() is counter.sharded_step()
    else:
        got = counter.count_sharded(codes, lengths)
    want = JaxCounter(JaxConfig()).count_sharded(
        codes, lengths, make_mesh((1, 1), jax.devices()[:1]))
    _assert_same(got, want)


def test_counter_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        KmerCounter(EngineConfig(), device="cuda")


# --- the graft entry ---------------------------------------------------------


def test_graft_entry_matches_kmer_tpu():
    fn, args = graft_entry.entry("cpu")
    got = fn(*args)
    jfn, jargs = jax_graft.entry()
    want = jfn(*jargs)
    assert args[0].shape == (256, 64) and args[0].device.type == "cpu"
    assert np.array_equal(args[0].numpy(), np.asarray(jargs[0]))
    assert got.distinct() == int(want.n_unique)
    _assert_same(got, want)


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import kmer_tpu_torch.config, kmer_tpu_torch.models\n"
        "import kmer_tpu_torch.ops.dense_count, kmer_tpu_torch.streaming\n"
        "import kmer_tpu_torch.graft_entry, kmer_tpu_torch.cli\n"
        "import kmer_tpu_torch.parallel.mesh, kmer_tpu_torch.parallel.comm\n"
        "import kmer_tpu_torch.parallel.multihost\n"
        "import kmer_tpu_torch.parallel.launch\n"
        "import kmer_tpu_torch.parallel.dist\n"
        "import kmer_tpu_torch.parallel.streaming\n"
        "import kmer_tpu_torch.parallel.driver\n"
        "import kmer_tpu_torch.parallel.shindex\n"
        "import kmer_tpu_torch.parallel.query, kmer_tpu_torch.bench\n"
        "import kmer_tpu_torch.bench_entry, kmer_tpu_torch.runs.sustained\n"
        "import kmer_tpu_torch.runs.ingest, kmer_tpu_torch.runs.common\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kmer_tpu', 'scripts', 'probe_ingest_rss', "
        "'sustained_r4'))\n"
        "assert not bad, bad\n"
    )
    got = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr

