"""The port's KmerTable, joins, parity suite and CLI against ``kmer_tpu``'s:
the same row ids through insert / delete / vacuum with scan == index,
the same GROUP BY, join pairs and outer rows, every parity check
passing, and the CLI's CSV ``count``, ``query``, ``extract`` and
``datagen`` printing what ``python -m kmer_tpu`` prints."""

import numpy as np
import pytest
import torch

import kmer_tpu.cli as jax_cli
import kmer_tpu.joins as jjoins
import kmer_tpu.parity as jparity
from kmer_tpu.api import KmerTable as JaxTable
from kmer_tpu.packed import PackedKmers as JaxPacked
from kmer_tpu.types import Qkmer as JQkmer
import kmer_tpu_torch.cli as cli
import kmer_tpu_torch.joins as joins
from kmer_tpu_torch.api import KmerTable
from kmer_tpu_torch.errors import InvalidDnaSequenceError
from kmer_tpu_torch.io.datagen import generate_test_rows, rows_to_csv
from kmer_tpu_torch.packed import PackedKmers
from kmer_tpu_torch.parity import CHECKS, run_parity, run_scale_parity
from kmer_tpu_torch.types import Qkmer

EQ = ["acga", "", "a", "t" * 32]
PREFIX = ["", "a", "ac", "t", "t" * 32]
PATTERN = ["angry", "nn", "r", "n" * 8, "u"]


def _answers(t, how):
    return ([getattr(t, f"{how}_eq")(q).tolist() for q in EQ]
            + [getattr(t, f"{how}_prefix")(q).tolist() for q in PREFIX]
            + [getattr(t, f"{how}_pattern")(q).tolist() for q in PATTERN])


@pytest.mark.parametrize("indexed", [False, True])
def test_table_through_mutations_matches_kmer_tpu(indexed):
    rows = generate_test_rows(400, seed=7)
    rows += [("ACGT", "acga", "angry"), ("A", "", "n"), ("TT", "t" * 32, "u")]
    port = KmerTable.from_rows(rows, device="cpu")
    ref = JaxTable.from_rows(rows)
    if indexed:
        port.create_index()
        ref.create_index()

    def same():
        assert _answers(port, "where") == _answers(ref, "where")
        assert _answers(port, "where") == _answers(port, "scan")
        assert port.group_by_kmer().to_dict() == ref.group_by_kmer().to_dict()
        assert port.count() == ref.count() == len(port)
        assert port.distinct_kmers() == ref.distinct_kmers()

    same()
    extra = generate_test_rows(30, seed=8) + [("C", "acga", "acgn")]
    assert port.insert_rows(extra) == ref.insert_rows(extra) == 31
    same()
    assert port.delete_where_kmer_eq("acga") == ref.delete_where_kmer_eq("acga")
    assert port.delete_where_dna_eq(rows[3][0]) == ref.delete_where_dna_eq(
        rows[3][0])
    assert port.delete_ids([0, 1, 1]) == ref.delete_ids([0, 1, 1])
    same()
    ids = port.where_prefix("a")[:5]
    assert port.rows(ids) == ref.rows(ids)
    port.vacuum()
    ref.vacuum()
    assert port.n_slots == ref.n_slots
    same()


def test_insert_validates_every_row_first():
    t = KmerTable.from_rows(generate_test_rows(20, seed=1), device="cpu")
    before = (len(t), t.kmer.to_strings())
    with pytest.raises(InvalidDnaSequenceError, match="Invalid DNA Sequence"):
        t.insert_rows([("ACGT", "acgt", "n"), ("ACGTX", "acgt", "n")])
    assert (len(t), t.kmer.to_strings()) == before


def test_from_csv_errors_and_blank_lines(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("dna,kmer,qkmer\nACGT,acgt,acgt\n\nACGT,acgt\n")
    with pytest.raises(ValueError) as port_err:
        KmerTable.from_csv(str(bad), device="cpu")
    with pytest.raises(ValueError) as ref_err:
        JaxTable.from_csv(str(bad))
    assert str(port_err.value) == str(ref_err.value)
    assert ":4:" in str(port_err.value)
    ok = tmp_path / "ok.csv"
    ok.write_text("dna,kmer,qkmer\nACGT,acgt,acgt\n\nA,c,n\n")
    assert len(KmerTable.from_csv(str(ok), device="cpu")) == 2
    header = tmp_path / "header.csv"
    header.write_text("kmer,dna\nacgt,ACGT\n")
    with pytest.raises(ValueError, match=":1:"):
        KmerTable.from_csv(str(header), device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        KmerTable.from_rows([("A", "a", "a")], device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        run_parity(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["query", "--input", "no-such.csv", "--eq", "a"])


def test_joins_match_kmer_tpu():
    rows = generate_test_rows(400, seed=15)
    left = [r[1].lower() for r in rows[:200]] + ["", "t" * 32, "t", "tt"]
    right = [r[1].lower() for r in rows[200:]] + left[:30] + ["t" * 32, ""]
    L, R = PackedKmers.from_strings(left), PackedKmers.from_strings(right)
    JL, JR = JaxPacked.from_strings(left), JaxPacked.from_strings(right)
    for name in ("join_eq", "join_right_starts_with_left"):
        got = getattr(joins, name)(L, R)
        want = getattr(jjoins, name)(JL, JR)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for how in ("inner", "left", "right", "full"):
            assert (joins.outer_extend(got, len(left), len(right), how)
                    == jjoins.outer_extend(want, len(left), len(right), how))
    pats = [r[2] for r in rows[:60]] + ["", "n", "t" * 32]
    np.testing.assert_array_equal(
        joins.join_pattern([Qkmer(p) for p in pats], R),
        jjoins.join_pattern([JQkmer(p) for p in pats], JR))


def test_run_parity_passes_every_check(capsys):
    assert run_parity(device="cpu")
    out = capsys.readouterr().out.splitlines()
    names = [name for name, _ in jparity.CHECKS]
    assert [name for name, _ in CHECKS] == names and len(names) == 11
    assert out == [f"PASS  {name}" for name in names]


def test_run_scale_parity_small(capsys):
    assert run_scale_parity(n_rows=1500, n_probes=12, device="cpu")
    out = capsys.readouterr().out
    assert "FAIL" not in out and "scale parity at 1500 rows: OK" in out


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "rows.csv"
    rows = generate_test_rows(300, seed=21)
    rows += [("ACGTACGTACGTACGTACGT" * 40, "acga", "angry"), ("A", "", "n")]
    rows_to_csv(rows, str(path))
    return str(path)


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    summary = [ln for ln in cap.err.splitlines() if ln.startswith("#")]
    return rc, cap.out, summary


CLI_CASES = {
    "count kmer column": ["count", "-k", "8"],
    "count top": ["count", "-k", "8", "--top", "7"],
    "count dna column k8": ["count", "-k", "8", "--from-dna-column",
                            "--batch", "256"],
    "count dna column canonical": ["count", "-k", "5", "--from-dna-column",
                                   "--canonical", "--top", "20", "--batch",
                                   "64", "--slots", "4096"],
    "query eq": ["query", "--eq", "acga"],
    "query eq index": ["query", "--eq", "acga", "--index"],
    "query prefix": ["query", "--prefix", "ac"],
    "query prefix index": ["query", "--prefix", "ac", "--index"],
    "query pattern": ["query", "--pattern", "nnnn"],
    "query pattern index": ["query", "--pattern", "nnnn", "--index"],
    "query none": ["query"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_on_csv_matches_kmer_tpu(case, csv_path, capsys, monkeypatch):
    monkeypatch.setenv("KMER_TPU_COMPILE_CACHE", "0")
    argv = CLI_CASES[case][:1] + ["--input", csv_path] + CLI_CASES[case][1:]
    got = _run(cli.main, argv + ["--device", "cpu"], capsys)
    want = _run(jax_cli.main, argv, capsys)
    assert got == want
    if case.startswith("count"):
        assert got[1].count("\n") > 5


@pytest.mark.parametrize("dna, k", [("ACGTACGT", 3), ("ACGTACGT", 8)])
def test_cli_extract_matches_kmer_tpu(dna, k, capsys, monkeypatch):
    monkeypatch.setenv("KMER_TPU_COMPILE_CACHE", "0")
    argv = ["extract", "--dna", dna, "-k", str(k)]
    assert _run(cli.main, argv, capsys) == _run(jax_cli.main, argv, capsys)


def test_cli_datagen_matches_kmer_tpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("KMER_TPU_COMPILE_CACHE", "0")
    a, b = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    rc, out, _ = _run(cli.main, ["datagen", "--rows", "77", "--seed", "5",
                                 "--out", a], capsys)
    jrc, jout, _ = _run(jax_cli.main, ["datagen", "--rows", "77", "--seed",
                                       "5", "--out", b], capsys)
    assert rc == jrc == 0 and out.replace(a, b) == jout
    assert open(a).read() == open(b).read()


def test_cli_parity(capsys):
    rc, out, _ = _run(cli.main, ["parity", "--device", "cpu"], capsys)
    assert rc == 0 and out.count("PASS") == 11 and "FAIL" not in out
