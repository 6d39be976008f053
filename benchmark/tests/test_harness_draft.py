"""The scaffolded draft (``hsap-draft-k21``): its generator, its plain
reference and its cell.  The same seed gives the same bytes and every seed
the same windows; the reference equals a ``collections.Counter`` of each
contig counted alone; the configuration's ``n_policy`` is its mix's; and
the same cell run with the program's default "skip", which joins the
flanks of every N run, comes out not correct."""

import collections
import time

import numpy as np
import pytest

from benchmark.gen import draft_assembly
from benchmark.harness import run_cell
from benchmark.reference import draft_assembly as ref_draft
from benchmark.spec import Spec

import tiny

CELL = "hsap-draft-k21.fasta-break"
COMP = str.maketrans("ACGT", "TGCA")
SEEDS = (7, 2 ** 33 + 11)


def _cfg(**extra):
    spec = Spec()
    return {**spec.config(spec.workload(CELL)), **tiny.config(CELL), **extra}


def _counter_table(contigs, k, canonical=True):
    c = collections.Counter()
    for s in contigs:
        for i in range(len(s) - k + 1):
            w = s[i: i + k]
            c[min(w, w.translate(COMP)[::-1]) if canonical else w] += 1
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    items = []
    for s, n in c.items():
        v = 0
        for ch in s:
            v = (v << 2) | code[ch]
        items.append((v << (64 - 2 * k), n))
    items.sort()
    return (np.array([i for i, _ in items], np.uint64),
            np.array([n for _, n in items], np.int64))


def test_the_configuration_policy_is_its_mix_option():
    spec = Spec()
    cell = spec.workload(CELL)
    assert spec.config(cell)["n_policy"] == "break"
    assert spec.mix(cell)["options"]["n_policy"] == "break"
    tiny_mix = tiny.mix(CELL)
    assert tiny_mix["options"]["n_policy"] == spec.config(cell)["n_policy"]


def test_full_scale_counts_from_config():
    cfg = Spec().config(Spec().workload(CELL))
    total = n_bases = contigs = 0
    for sc in cfg["scaffolds"]:
        g = sc["n_runs"]
        total += sc["total_bases"]
        n_bases += (2 * g["telomere_bases"] + g["centromere_bases"]
                    + g["small_gaps"] * g["small_gap_bases"])
        contigs += g["small_gaps"] + 2
    total += cfg["unplaced"]["total_bases"]
    contigs += cfg["unplaced"]["scaffolds"]
    assert [sc["total_bases"] for sc in cfg["scaffolds"]] == [248_956_422,
                                                              242_193_529]
    assert total == 503_649_951 and n_bases == 18_980_000
    assert contigs == 9_904
    assert cfg["sequences"] == len(cfg["scaffolds"]) + \
        cfg["unplaced"]["scaffolds"]
    # every contig is longer than k, so each gives its length - (k - 1)
    assert total - n_bases - contigs * (cfg["k"] - 1) == 484_471_871


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_bytes_and_fixed_windows(tmp_path, seed):
    cfg = _cfg()
    a = draft_assembly.sample(cfg, seed)
    b = draft_assembly.sample(cfg, seed)
    assert np.array_equal(a.codes, b.codes)
    other = draft_assembly.sample(cfg, seed + 1)
    assert not np.array_equal(other.codes, a.codes)
    n_contigs = sum(sc["n_runs"]["small_gaps"] + 2
                    for sc in cfg["scaffolds"]) + cfg["unplaced"]["scaffolds"]
    for d in (a, other):
        lens = d.contig_lengths()
        assert lens.size == n_contigs and lens.min() >= cfg["k"]
        assert d.windows() == int((d.codes < 4).sum()) - n_contigs * (
            cfg["k"] - 1)
    assert a.windows() == other.windows()
    pa, pb = tmp_path / "a.fasta", tmp_path / "b.fasta"
    size = draft_assembly.write(a, cfg, "fasta", str(pa))
    draft_assembly.write(b, cfg, "fasta", str(pb))
    text = pa.read_bytes()
    assert text == pb.read_bytes() and size == len(text)
    records = text.split(b">")[1:]
    assert len(records) == len(cfg["scaffolds"]) + cfg["unplaced"]["scaffolds"]
    for i, (rec, codes) in enumerate(zip(records, a.scaffolds())):
        head, _, body = rec.partition(b"\n")
        assert head == f"scaffold_{i + 1}".encode()
        lines = body.split(b"\n")
        assert all(len(x) == cfg["line_bases"] for x in lines[:-2])
        assert b"".join(lines) == draft_assembly.LETTERS[codes].tobytes()


@pytest.mark.parametrize("seed,k", [(4, 21), (2 ** 35 + 1, 21), (5, 7)])
def test_reference_equals_counter_of_each_contig(seed, k):
    cfg = _cfg(k=k, repeats={"element_bases": 60, "families": 2,
                             "divergence": 0.05, "share": 0.4})
    d = draft_assembly.sample(cfg, seed)
    contigs = []
    for codes in d.scaffolds():
        text = draft_assembly.LETTERS[codes].tobytes().decode()
        contigs.extend(p for p in text.split("N") if p)
    assert len(contigs) == d.contig_lengths().size
    want = _counter_table(contigs, k)
    got = ref_draft.table(d)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert int(got[1].sum()) == d.windows()
    assert got[1].max() > 1  # the repeats repeat
    # joined across its N runs, the draft has other windows
    joined = _counter_table(["".join(contigs)], k)
    assert joined[0].size != want[0].size or not np.array_equal(joined[0],
                                                                want[0])


def test_skip_against_the_break_reference_is_not_correct():
    """A planted fault: the cell run with the program's default policy,
    which joins the flanks of every N run, against the reference that
    breaks there."""
    mix = {**tiny.mix(CELL)}
    mix["options"] = {**mix["options"], "n_policy": "skip"}
    result = run_cell(CELL, 2 ** 33 + 13, 0.1, False, "cpu",
                      time.perf_counter(), config=tiny.config(CELL), mix=mix)
    assert result["correct"] is False
    assert result["checks"]["mismatched_rows"]["value"] > 0
    assert result["checks"]["row_count_gap"]["value"] > 0
    sound = run_cell(CELL, 2 ** 33 + 13, 0.1, False, "cpu",
                     time.perf_counter(), config=tiny.config(CELL),
                     mix=tiny.mix(CELL))
    assert sound["correct"] is True
