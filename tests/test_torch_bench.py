"""The port's bench (``kmer_tpu_torch.bench`` and ``python -m
kmer_tpu_torch bench``) vs ``kmer_tpu.bench`` on the cases of
tests/test_bench.py, on the CPU: the same ``unique_kmers`` and
``total_kmers`` (exact), the same metric and detail keys, and the same
phase names.
"""

import json

import pytest
import torch

from kmer_tpu import bench as jb
from kmer_tpu_torch import bench as tb
from kmer_tpu_torch.cli import main

CPU = torch.device("cpu")
PHASES = {"extract", "sort", "segment_counts"}


def _same_counts(a, b):
    assert a["metric"] == b["metric"] and a["unit"] == b["unit"]
    assert a["detail"]["unique_kmers"] == b["detail"]["unique_kmers"]
    assert a["detail"]["total_kmers"] == b["detail"]["total_kmers"]


@pytest.mark.parametrize("k", [8, 21])
def test_fused_mode_matches_kmer_tpu(k):
    want = jb.run_bench(n_reads=512, read_len=48, k=k)
    got = tb.run_bench(n_reads=512, read_len=48, k=k, device=CPU)
    _same_counts(got, want)
    assert got["detail"]["total_kmers"] == 512 * (48 - k + 1)
    # kmer_tpu's detail keys, plus the phases at every k
    assert set(want["detail"]) - {"phases", "phases_sum_ms",
                                  "hbm_sol_bytes_per_s"} <= set(got["detail"])
    if "phases" in want["detail"]:
        assert set(got["detail"]["phases"]) == set(want["detail"]["phases"])
    assert set(got["detail"]["phases"]) == PHASES
    for ph in got["detail"]["phases"].values():
        assert ph["ms"] > 0 and ph["gb_per_s"] > 0
        assert ph["pct_sol"] is None  # no published peak for a CPU
    assert got["detail"]["hbm_sol_bytes_per_s"] is None
    assert got["detail"]["device"] == "cpu"
    assert got["value"] > 0 and got["vs_baseline"] > 0


def test_stream_mode_matches_kmer_tpu_and_fused():
    want = jb.run_bench_stream(n_reads=512, read_len=48, k=21)
    got = tb.run_bench_stream(n_reads=512, read_len=48, k=21, device=CPU)
    _same_counts(got, want)
    fused = tb.run_bench(n_reads=512, read_len=48, k=21, device=CPU)
    assert got["detail"]["unique_kmers"] == fused["detail"]["unique_kmers"]
    assert got["detail"]["mode"] == "stream"


def test_chr_mode_matches_kmer_tpu():
    want = jb.run_chr_bench(n_bases=2048, k=31, canonical=False, seed=0)
    got = tb.run_chr_bench(n_bases=2048, k=31, canonical=False, seed=0,
                           device=CPU)
    assert got["metric"] == want["metric"]
    assert got["detail"]["unique_kmers"] == want["detail"]["unique_kmers"]
    assert got["detail"]["total_kmers"] == 2048 - 31 + 1
    assert set(want["detail"]) <= set(got["detail"])


def test_chr_mode_canonical_matches_kmer_tpu():
    want = jb.run_chr_bench(n_bases=4000, k=31, seed=3)
    got = tb.run_chr_bench(n_bases=4000, k=31, seed=3, device=CPU)
    assert got["detail"]["n_bases"] == want["detail"]["n_bases"] == 4000
    assert got["detail"]["unique_kmers"] == want["detail"]["unique_kmers"]


def test_coverage_mode_matches_kmer_tpu():
    want = jb.run_bench(n_reads=512, read_len=48, k=8, coverage_genome=2000)
    got = tb.run_bench(n_reads=512, read_len=48, k=8, coverage_genome=2000,
                       device=CPU)
    _same_counts(got, want)
    assert got["detail"]["mode"] == "coverage"
    assert (got["detail"]["mean_kmer_multiplicity"]
            == want["detail"]["mean_kmer_multiplicity"])


def test_stream_mode_needs_whole_words():
    with pytest.raises(ValueError, match="multiple of 16"):
        tb.run_bench_stream(n_reads=3, read_len=5, k=3, device=CPU)


@pytest.mark.parametrize("name, peak", [
    ("NVIDIA H100 80GB HBM3", 3.35e12),
    ("NVIDIA H100 PCIe", 2.0e12),
    ("NVIDIA H100 NVL", 3.9e12),
])
def test_hbm_peak_by_card_name(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert tb.hbm_bytes_per_s("cuda") == peak


def test_hbm_peak_of_an_unknown_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="no published HBM peak"):
        tb.hbm_bytes_per_s("cuda")


def test_hbm_peak_on_cpu_is_none():
    assert tb.hbm_bytes_per_s("cpu") is None


@pytest.mark.parametrize("mode", ["fused", "stream", "chr"])
def test_cli_bench_last_line_is_the_result(mode, capsys, monkeypatch):
    # chr at its default size would be a full-size run: cut it here
    monkeypatch.setattr(tb.run_chr_bench, "__defaults__",
                        (4096, 31, True, 0, "cuda"))
    assert main(["bench", "--device", "cpu", "--mode", mode, "--reads",
                 "64", "--read-len", "48"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["detail"]["mode"] == mode
    assert out["detail"]["device"] == "cpu"


def test_cli_bench_unported_modes_raise():
    """--no-pallas is not ported and raises, citing its ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item"):
        main(["bench", "--device", "cpu", "--no-pallas"])


def test_cli_bench_shq_prints_its_metric(capsys, monkeypatch):
    """--mode shq runs the sharded-index bench on one rank in one
    process and prints its metric."""
    # the bench's default size is a full-size run: cut it here
    monkeypatch.setattr(tb.run_sharded_query_bench, "__defaults__",
                        (1 << 12, 256, 0, None))
    assert main(["bench", "--device", "cpu", "--mode", "shq"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "sharded_index_eq_lookups_per_s"
    assert out["detail"]["n_devices"] == 1
    assert out["detail"]["hits"] >= 256


@pytest.mark.parametrize("argv, metric", [
    (["--queries"], "index_eq_lookups_per_s_chip"),
    (["--mode", "pattern"], "index_pattern_lookups_per_s_chip"),
])
def test_cli_bench_query_modes_print_their_metric(argv, metric, capsys,
                                                  monkeypatch):
    # the benches' default sizes are full-size runs: cut them here
    monkeypatch.setattr(tb.run_query_bench, "__defaults__",
                        (1 << 12, 1 << 10, 0, "cuda"))
    monkeypatch.setattr(tb.run_pattern_bench, "__defaults__",
                        (1 << 12, 1 << 8, 0, "cuda"))
    assert main(["bench", "--device", "cpu", *argv]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == metric and out["detail"]["device"] == "cpu"


def test_cli_bench_trace_writes_a_profile(tmp_path, capsys):
    assert main(["bench", "--device", "cpu", "--reads", "32", "--read-len",
                 "32", "-k", "11", "--trace", str(tmp_path)]) == 0
    assert list(tmp_path.glob("*.json"))
    json.loads(capsys.readouterr().out.strip().splitlines()[-1])
