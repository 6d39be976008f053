"""The plain references equal a ``collections.Counter`` count of the same
inputs at tiny sizes, errors and N runs included; the control's table
(keys cut to 32 bits) does not."""

import collections

import numpy as np
import pytest

from benchmark.gen import assembly, wgs_reads
from benchmark.reference import assembly as ref_assembly
from benchmark.reference import kmers, wgs_reads as ref_reads
from benchmark.spec import Spec

COMP = str.maketrans("ACGT", "TGCA")


def _counter(seqs, k, canonical=True):
    c = collections.Counter()
    for s in seqs:
        for i in range(len(s) - k + 1):
            w = s[i: i + k]
            c[min(w, w.translate(COMP)[::-1]) if canonical else w] += 1
    return c


def _as_table(counter, k):
    """Counter of k-mer strings -> (left-aligned uint64 keys, counts)."""
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    items = []
    for s, n in counter.items():
        v = 0
        for ch in s:
            v = (v << 2) | code[ch]
        items.append((v << (64 - 2 * k), n))
    items.sort()
    return (np.array([i for i, _ in items], np.uint64),
            np.array([n for _, n in items], np.int64))


def _cfg(name, **extra):
    spec = Spec()
    w = next(w for w in spec.data["workloads"] if w["config"] == name)
    return {**spec.config(w), **extra}


@pytest.mark.parametrize("seed,k", [(1, 21), (2 ** 40 + 3, 21), (5, 7),
                                    (9, 31)])
def test_reads_reference_equals_counter(seed, k):
    cfg = _cfg("scer-wgs-k21", genome_bases=900, n_reads=120, read_len=40,
               substitution_rate=0.03, k=k)
    r = wgs_reads.sample(cfg, seed)
    assert r.err_at.size > 0
    seqs = ["".join("ACGT"[c] for c in row)
            for row in r.read_codes(0, r.n_reads)]
    want = _as_table(_counter(seqs, k), k)
    got = ref_reads.table(r)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert int(got[1].sum()) == r.windows()


@pytest.mark.parametrize("seed", [4, 2 ** 35 + 1])
def test_assembly_reference_equals_counter_with_n_runs(seed):
    cfg = _cfg("grch38-chr1-k31", total_bases=5000,
               n_runs={"telomere_bases": 30, "centromere_bases": 400,
                       "small_gaps": 5, "small_gap_bases": 20},
               repeats={"element_bases": 60, "families": 2,
                        "divergence": 0.05, "share": 0.4})
    a = assembly.sample(cfg, seed)
    text = assembly.LETTERS[a.codes].tobytes().decode()
    assert "N" in text
    # "skip": N bases dropped, flanks joined (the port's parser)
    want = _as_table(_counter([text.replace("N", "")], cfg["k"]), cfg["k"])
    got = ref_assembly.table(a)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[1].max() > 1  # the repeats repeat


def test_window_values_by_doubling_equal_a_loop():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 4, (3, 70), dtype=np.uint8)
    for k in (1, 2, 3, 13, 21, 31):
        got = kmers.window_values(rows, k)
        for i in range(70 - k + 1):
            v = 0
            for c in rows[1, i: i + k]:
                v = (v << 2) | int(c)
            assert int(got[1, i]) == v


def test_control_truncation_merges_keys():
    keys = np.array([0x0123456700000000, 0x0123456711110000,
                     0x7000000000000000], np.uint64)
    counts = np.array([2, 3, 4], np.int64)
    k32, c32 = kmers.truncate(keys, counts, 32)
    assert k32.tolist() == [0x0123456700000000, 0x7000000000000000]
    assert c32.tolist() == [5, 4]
    same = kmers.truncate(keys, counts, 64)
    assert same[0] is keys and same[1] is counts


@pytest.mark.parametrize("k", [5, 21, 31])
def test_sequence_keys_in_blocks_equal_one_block(k):
    seq = np.random.default_rng(k).integers(0, 4, 1000, dtype=np.uint8)
    whole = kmers.canonical_keys(seq[None, :], k)[0]
    for block in (1, 7, 64, 999):
        assert np.array_equal(kmers.sequence_keys(seq, k, block=block), whole)
