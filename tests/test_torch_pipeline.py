"""The port's count_file and CLI vs kmer_tpu's, on the CPU: trimmed
tables equal array for array, CLI stdout equal line for line.  The
fold's growth, spills and checkpoints are held in
tests/test_torch_fold_pipeline.py.
"""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from kmer_tpu.cli import main as jax_main
from kmer_tpu.pipeline import count_file as jax_count_file
from kmer_tpu_torch.pipeline import count_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(rng, n, lmin, lmax):
    out = []
    for _ in range(n):
        s = "".join("ACGT"[c] for c in rng.integers(0, 4, int(
            rng.integers(lmin, lmax))))
        out.append(s)
    out[0] = "T" * max(lmax - 1, 1)  # an all-t read
    return out


def _write(path, seqs, fmt):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        for i, s in enumerate(seqs):
            if fmt == "fastq":
                f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
            else:  # FASTA, sequence wrapped at 60 columns
                body = "\n".join(s[j: j + 60] for j in range(0, len(s), 60))
                f.write(f">r{i} read\n{body}\n")


def _assert_same(path, fmt, k, **kw):
    want = jax_count_file(path, fmt, k, **kw).trim()
    table = count_file(path, fmt, k, device="cpu", **kw)
    t = table.trim()
    hi, lo, length, _, _ = t.to_numpy()
    np.testing.assert_array_equal(hi, np.asarray(want.hi))
    np.testing.assert_array_equal(lo, np.asarray(want.lo))
    np.testing.assert_array_equal(length, np.asarray(want.length))
    np.testing.assert_array_equal(t.counts64(), np.asarray(want.counts))
    assert table.distinct() == int(want.n_unique)
    return table


@pytest.mark.parametrize("fmt, name, k, canonical", [
    ("fastq", "r.fastq", 21, True),
    ("fastq", "r.fastq", 9, False),
    ("fasta", "r.fasta", 21, True),
    ("fasta", "r.fa", 32, False),
    ("fastq", "r.fastq.gz", 31, True),
])
def test_count_file_matches_kmer_tpu(tmp_path, fmt, name, k, canonical):
    rng = np.random.default_rng(k)
    path = str(tmp_path / name)
    _write(path, _records(rng, 300, 1, 150), fmt)
    table = _assert_same(path, fmt, k, canonical=canonical, batch=64)
    assert table.distinct() > 0


def test_long_reads_split_at_width(tmp_path):
    rng = np.random.default_rng(5)
    path = str(tmp_path / "long.fastq")
    _write(path, _records(rng, 40, 200, 900), "fastq")
    _assert_same(path, "fastq", 21, canonical=True, batch=64, width=160)


def test_all_reads_shorter_than_k(tmp_path):
    rng = np.random.default_rng(15)
    path = str(tmp_path / "short.fastq")
    _write(path, _records(rng, 50, 1, 8), "fastq")
    table = _assert_same(path, "fastq", 9, batch=16)
    assert table.to_dict() == {} and table.distinct() == 0


def test_empty_file_raises(tmp_path):
    path = str(tmp_path / "empty.fastq")
    open(path, "w").close()
    with pytest.raises(ValueError, match="empty"):
        count_file(path, "fastq", 9, device="cpu")


@pytest.mark.parametrize("args", [
    ["-k", "6", "--top", "0"],
    ["-k", "21", "--canonical", "--top", "25"],
])
def test_cli_stdout_matches_kmer_tpu(tmp_path, capsys, args):
    rng = np.random.default_rng(9)
    path = str(tmp_path / "r.fastq")
    _write(path, _records(rng, 200, 5, 120), "fastq")
    assert jax_main(["count", "--input", path, *args]) == 0
    want = capsys.readouterr()
    got = subprocess.run(
        [sys.executable, "-m", "kmer_tpu_torch", "count", "--input", path,
         *args, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr
    assert got.stdout == want.out
    summary = [ln for ln in got.stderr.splitlines() if ln.startswith("# ")]
    assert summary == [ln for ln in want.err.splitlines()
                       if ln.startswith("# ")]


def test_cli_save_loads_in_kmer_tpu(tmp_path):
    from kmer_tpu.parallel.streaming import load_wide

    rng = np.random.default_rng(4)
    path = str(tmp_path / "r.fastq")
    _write(path, _records(rng, 100, 20, 80), "fastq")
    out = str(tmp_path / "t.npz")
    got = subprocess.run(
        [sys.executable, "-m", "kmer_tpu_torch", "count", "--input", path,
         "-k", "11", "--canonical", "--save", out, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr
    table, meta = load_wide(out)
    assert meta == {"version": 2, "k": 11, "canonical": True}
    want = count_file(path, "fastq", 11, canonical=True, device="cpu")
    assert table.to_dict() == want.to_dict()


@pytest.mark.parametrize("seq", ["ACGTacgt", "", "ACGNT", "ttttTTTT"])
def test_encoders_match_kmer_tpu(seq):
    from kmer_tpu import codec as jcodec
    from kmer_tpu.errors import InvalidDnaSequenceError as JaxError
    from kmer_tpu_torch import codec
    from kmer_tpu_torch.errors import InvalidDnaSequenceError
    from kmer_tpu_torch.native import encode_dna_fast

    if "N" in seq:
        for enc in (codec.encode_dna, encode_dna_fast):
            with pytest.raises(InvalidDnaSequenceError) as err:
                enc(seq)
            with pytest.raises(JaxError) as want:
                jcodec.encode_dna(seq)
            assert str(err.value) == str(want.value) == "Invalid DNA Sequence"
        return
    want = jcodec.encode_dna(seq)
    np.testing.assert_array_equal(codec.encode_dna(seq), want)
    np.testing.assert_array_equal(encode_dna_fast(seq), want)
    assert codec.decode_codes(want) == seq.lower()
