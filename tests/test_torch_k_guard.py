"""The port's k guard, and ``count_file`` on messy input, on the CPU.

Every entry point that packs or extracts windows raises the engine's
``InvalidKmerLengthError`` ("Invalid KMER Length") for k outside [1, 32]:
the host packer ``native.rows_packed`` first of all, and through it (or
its own guard) each entry point that reaches it.  ``kmer_tpu`` raises
other errors there, or none; that difference is by design.  Then
``count_file`` is held against ``kmer_tpu``'s on FASTA/FASTQ files with
N, lowercase and IUPAC letters, empty and wrapped records.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kmer_tpu.pipeline import count_file as jax_count_file
from kmer_tpu_torch import native
from kmer_tpu_torch.errors import InvalidKmerLengthError
from kmer_tpu_torch.kernels.wire_keys import wire_keys
from kmer_tpu_torch.parallel.driver import run_distcount
from kmer_tpu_torch.pipeline import column_batch_feed, count_file
from kmer_tpu_torch.streaming import count_long_sequence, count_read_stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAD_K = [0, 33]
SEQ = "ACGTTGCAAGGCTTACCGATACGTTGCAAGGCTTACCGATACGTA"  # 45 bases
ERROR_LINE = "kmer_tpu_torch.errors.InvalidKmerLengthError: Invalid KMER Length"


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("kguard") / "r.fa"
    path.write_text(f">a\n{SEQ}\n>b\n{SEQ[::-1]}\n")
    return str(path)


@pytest.fixture(scope="module")
def csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("kguard") / "d.csv"
    path.write_text(f"dna,kmer,qkmer\n{SEQ},acgt,acgt\n{SEQ[:40]},acga,"
                    "acga\n")
    return str(path)


def _codes(n=45):
    return np.random.default_rng(0).integers(0, 4, n, dtype=np.uint8)


def _rows_packed(k, fasta, csv):
    native.rows_packed(_codes(), np.array([0, 45]), 128, k)


def _count_file(k, fasta, csv):
    count_file(fasta, "fasta", k, device="cpu")


def _count_read_stream(k, fasta, csv):
    codes = _codes(4 * 48).reshape(4, 48)
    count_read_stream([(codes, np.full(4, 48))], k, device="cpu")


def _wire_keys(k, fasta, csv):
    wire = torch.zeros((2, 4), dtype=torch.int32)
    wire[:, -1] = 48
    wire_keys(wire, 48, k, canonical=True)


def _count_long_sequence(k, fasta, csv):
    count_long_sequence(_codes(), k, chunk=64, device="cpu")


def _run_distcount(k, fasta, csv):
    run_distcount(fasta, k, batch=16, width=48, device="cpu")


def _column_batch_feed(k, fasta, csv):
    feed, _, _ = column_batch_feed([SEQ, SEQ[:40]], k, batch=16)
    list(feed)


ENTRY_POINTS = [_rows_packed, _count_file, _count_read_stream, _wire_keys,
                _count_long_sequence, _run_distcount, _column_batch_feed]


@pytest.mark.parametrize("k", BAD_K)
@pytest.mark.parametrize("entry", ENTRY_POINTS, ids=lambda f: f.__name__[1:])
def test_entry_point_raises_invalid_kmer_length(entry, k, fasta, csv):
    with pytest.raises(InvalidKmerLengthError, match="Invalid KMER Length"):
        entry(k, fasta, csv)


@pytest.mark.parametrize("k", [1, 32])
def test_rows_packed_accepts_the_ends_of_the_range(k):
    words, lens = native.rows_packed(_codes(), np.array([0, 45]), 64, k)
    assert words.shape[0] == lens.size >= 1


@pytest.mark.parametrize("k", BAD_K)
@pytest.mark.parametrize("argv", [
    ["distcount", "--input", "{fasta}", "--batch", "16", "--width", "48"],
    ["count", "--input", "{csv}", "--from-dna-column", "--batch", "16"],
], ids=["distcount", "count-from-dna-column"])
def test_cli_prints_the_engine_error_and_fails(argv, k, fasta, csv):
    args = [a.format(fasta=fasta, csv=csv) for a in argv]
    got = subprocess.run(
        [sys.executable, "-m", "kmer_tpu_torch", *args, "-k", str(k),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"), timeout=120)
    assert got.returncode != 0
    assert got.stderr.strip().splitlines()[-1] == ERROR_LINE
    assert got.stdout == ""


# --- count_file on messy input ----------------------------------------------

IUPAC = "RYSWKMBDHVN"


def _messy_records(rng, n):
    """Reads of ACGT in either case, with N and other IUPAC letters here
    and there, and some empty reads."""
    out = []
    for i in range(n):
        length = int(rng.integers(0, 120)) if i % 7 else 0
        s = "".join(rng.choice(list("ACGTacgt"), length))
        s = list(s)
        for _ in range(int(rng.integers(0, 3))):
            if s:
                s[int(rng.integers(0, len(s)))] = str(rng.choice(
                    list(IUPAC + IUPAC.lower())))
        out.append("".join(s))
    out[1] = "N" * 30
    out[2] = "acgtn" * 12
    return out


def _write_messy(path, seqs, fmt):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            if fmt == "fastq":
                f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
            else:  # wrapped at 13 or 60 columns, some records empty
                w = 13 if i % 2 else 60
                body = "".join(s[j: j + w] + "\n"
                               for j in range(0, len(s), w))
                f.write(f">r{i} some description\n{body}")


@pytest.mark.parametrize("fmt,k,canonical", [
    ("fasta", 21, True), ("fasta", 3, False), ("fastq", 21, True),
    ("fastq", 32, False)])
def test_count_file_on_messy_input_matches_kmer_tpu(tmp_path, fmt, k,
                                                     canonical):
    rng = np.random.default_rng(k + 100 * canonical)
    path = str(tmp_path / f"messy.{fmt}")
    _write_messy(path, _messy_records(rng, 200), fmt)
    want = jax_count_file(path, fmt, k, canonical=canonical, batch=64,
                          width=64).trim()
    got = count_file(path, fmt, k, canonical=canonical, batch=64, width=64,
                     device="cpu")
    t = got.trim()
    hi, lo, length, _, _ = t.to_numpy()
    np.testing.assert_array_equal(hi, np.asarray(want.hi))
    np.testing.assert_array_equal(lo, np.asarray(want.lo))
    np.testing.assert_array_equal(length, np.asarray(want.length))
    np.testing.assert_array_equal(t.counts64(), np.asarray(want.counts))
    assert got.distinct() == int(want.n_unique) > 0
