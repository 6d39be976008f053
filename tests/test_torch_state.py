"""State carried across the two packages (count-table snapshots and
arrays), the port's JAX-free import, and its explicit device rule."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_tpu.ops.count import count_windows as jax_count_windows
from kmer_tpu.utils.checkpoint import load_table as jax_load_table
from kmer_tpu.utils.checkpoint import save_table as jax_save_table
from kmer_tpu_torch.ops.count import CountTable
from kmer_tpu_torch.pipeline import count_file
from kmer_tpu_torch.utils.checkpoint import load_table, save_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_table(seed=0, n=3000):
    """An untrimmed kmer_tpu table (k = 21, masked) with top-bit keys."""
    rng = np.random.default_rng(seed)
    hi = (rng.integers(0, 40, n).astype(np.uint64) << np.uint64(26)).astype(
        np.uint32)
    hi[::5] |= np.uint32(0x80000000)
    lo = (rng.integers(0, 4, n).astype(np.uint64) << np.uint64(22)).astype(
        np.uint32)
    valid = rng.random(n) < 0.8
    return jax_count_windows(jnp.asarray(hi), jnp.asarray(lo),
                             jnp.asarray(valid), 21)


def _arrays(t):
    return [np.asarray(a) for a in (t.hi, t.lo, t.length, t.counts)]


def test_kmer_tpu_snapshot_loads_in_port(tmp_path):
    jt = _jax_table(1)
    path = str(tmp_path / "jax.npz")
    jax_save_table(jt, path, {"k": 21, "canonical": True})
    table, meta = load_table(path)
    assert meta == {"version": 1, "k": 21, "canonical": True}
    for got, want in zip(table.to_numpy(), _arrays(jt.trim())):
        np.testing.assert_array_equal(got, want)
    assert table.distinct() == int(jt.n_unique)


def test_port_snapshot_loads_in_kmer_tpu(tmp_path):
    jt = _jax_table(2)
    table = CountTable.from_numpy(*_arrays(jt))  # untrimmed: save trims
    path = str(tmp_path / "port.npz")
    save_table(table, path, {"k": 21})
    back, meta = jax_load_table(path)
    assert meta == {"version": 1, "k": 21}
    for got, want in zip(_arrays(back), _arrays(jt.trim())):
        np.testing.assert_array_equal(got, want)
    assert back.to_dict() == table.to_dict() == jt.to_dict()


def test_numpy_round_trip():
    jt = _jax_table(3)
    arrays = _arrays(jt)
    table = CountTable.from_numpy(*arrays)
    assert table.capacity == arrays[0].size
    assert table.distinct() == int(jt.n_unique)
    assert table.total() == jt.total()
    for got, want in zip(table.to_numpy(), arrays):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(table.trim().to_numpy(), _arrays(jt.trim())):
        np.testing.assert_array_equal(got, want)


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import kmer_tpu_torch, kmer_tpu_torch.pipeline, kmer_tpu_torch.cli\n"
        "import kmer_tpu_torch.utils.checkpoint, kmer_tpu_torch.ops.wide\n"
        "import kmer_tpu_torch.parallel.streaming\n"
        "import kmer_tpu_torch.api, kmer_tpu_torch.index, kmer_tpu_torch.joins\n"
        "import kmer_tpu_torch.parity, kmer_tpu_torch.types\n"
        "import kmer_tpu_torch.ops.predicates, kmer_tpu_torch.io.datagen\n"
        "import kmer_tpu_torch.bench, kmer_tpu_torch.device\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib',"
        " 'kmer_tpu'))\n"
        "assert 'jax' not in sys.modules, bad\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
    )
    got = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr


def test_cuda_device_without_a_card_raises_before_any_work():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    # a path that does not exist: the device check must come first, so
    # nothing is read, parsed or counted on the CPU
    with pytest.raises(RuntimeError, match="cuda"):
        count_file("no-such-file.fastq", "fastq", 21, device="cuda")
    from kmer_tpu_torch.pipeline import count_batches_pipelined

    def batches():
        raise AssertionError("the feed was read")
        yield

    with pytest.raises(RuntimeError, match="cuda"):
        count_batches_pipelined(batches(), 21, device="cuda")


def test_cli_default_device_without_a_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    path = str(tmp_path / "r.fastq")
    with open(path, "w") as f:
        f.write("@r0\nACGTACGTACGTACGTACGTACGTAC\n+\n" + "I" * 26 + "\n")
    got = subprocess.run(
        [sys.executable, "-m", "kmer_tpu_torch", "count", "--input", path,
         "-k", "21"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert got.returncode != 0
    assert got.stdout == ""
    assert "torch.cuda.is_available() is False" in got.stderr


@pytest.mark.gpu
def test_count_file_on_cuda_equals_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from kmer_tpu_torch.kernels.segment_counts import segment_counts

    rng = np.random.default_rng(11)
    path = str(tmp_path / "r.fastq")
    with open(path, "w") as f:
        for i in range(500):
            s = "".join("ACGT"[c] for c in rng.integers(0, 4, 150))
            f.write(f"@r{i}\n{s}\n+\n{'I' * 150}\n")
    before = segment_counts.launches
    gpu = count_file(path, "fastq", 21, canonical=True, device="cuda")
    assert segment_counts.launches > before
    cpu = count_file(path, "fastq", 21, canonical=True, device="cpu")
    for got, want in zip(gpu.trim().to_numpy(), cpu.trim().to_numpy()):
        np.testing.assert_array_equal(got, want)
