"""The port's benchmark entry (``python -m kmer_tpu_torch.bench_entry``)
on the CPU: one JSON line on stdout with ``kmer_tpu``'s keys and exact
counts, ``detail`` on stderr, every mode dispatched, only the port's own
records surfaced, and no fallback from the default device."""

import json
import os
import subprocess
import sys

import pytest

from kmer_tpu import bench as jb
from kmer_tpu_torch import bench as tb
from kmer_tpu_torch import bench_entry
from kmer_tpu_torch.runs import common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = 4096


def _entry(mode: str) -> tuple[list[str], list[str]]:
    env = dict(os.environ, KMER_BENCH_MODE=mode,
               KMER_BENCH_READS=str(READS), KMER_BENCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    got = subprocess.run([sys.executable, "-m", "kmer_tpu_torch.bench_entry"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert got.returncode == 0, got.stderr
    return got.stdout.splitlines(), got.stderr.splitlines()


@pytest.mark.parametrize("mode,fn", [("fused", jb.run_bench),
                                     ("stream", jb.run_bench_stream)])
def test_entry_prints_kmer_tpu_keys_and_counts(mode, fn):
    out, err = _entry(mode)
    assert len(out) == 1
    result = json.loads(out[0])
    detail = json.loads(err[-1])["detail"]
    want = fn(n_reads=READS, read_len=150, k=21, canonical=True)
    want_detail = want.pop("detail")
    assert set(result) == set(want)
    assert result["metric"] == want["metric"] and result["value"] > 0
    for key in ("mode", "n_reads", "read_len", "k", "canonical",
                "total_kmers", "unique_kmers"):
        assert detail[key] == want_detail[key], key
    assert detail["total_kmers"] == READS * (150 - 21 + 1)
    assert detail["device"] == "cpu"
    # the plain versions run on the CPU, so no kernel launched
    assert detail["launches"] == {"wire_keys": 0, "codes_keys": 0,
                                  "stream_keys": 0, "segment_counts": 0}


@pytest.fixture
def cpu_entry(monkeypatch, tmp_path):
    """main() in process on the CPU, its records read from tmp_path."""
    monkeypatch.setenv("KMER_BENCH_DEVICE", "cpu")
    monkeypatch.setattr(common, "repo_root", lambda: str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("mode,name", [("chr", "run_chr_bench"),
                                       ("query", "run_query_bench"),
                                       ("pattern", "run_pattern_bench")])
def test_modes_dispatch(cpu_entry, monkeypatch, capsys, mode, name):
    calls = []

    def fake(**kw):
        calls.append(kw)
        return {"metric": name, "value": 1.0, "detail": {"mode": mode}}

    monkeypatch.setattr(tb, name, fake)
    monkeypatch.setenv("KMER_BENCH_MODE", mode)
    assert bench_entry.main() == 0
    out, err = capsys.readouterr()
    assert out.splitlines() == [json.dumps({"metric": name, "value": 1.0})]
    detail = json.loads(err.splitlines()[-1])["detail"]
    assert detail["mode"] == mode and "launches" in detail
    assert [str(c["device"]) for c in calls] == ["cpu"]


def test_fused_and_stream_take_the_reads(cpu_entry, monkeypatch, capsys):
    seen = []
    for mode, name in (("fused", "run_bench"), ("stream", "run_bench_stream")):
        monkeypatch.setattr(tb, name, lambda name=name, **kw: (
            seen.append((name, kw)) or {"metric": "m", "detail": {}}))
        monkeypatch.setenv("KMER_BENCH_MODE", mode)
        monkeypatch.setenv("KMER_BENCH_READS", "123")
        bench_entry.main()
    capsys.readouterr()
    assert [n for n, _ in seen] == ["run_bench", "run_bench_stream"]
    for _, kw in seen:
        assert (kw["n_reads"], kw["read_len"], kw["k"], kw["canonical"]) == (
            123, 150, 21, True)


def test_unknown_mode_raises(cpu_entry, monkeypatch):
    monkeypatch.setenv("KMER_BENCH_MODE", "shq")
    with pytest.raises(ValueError, match="not one of"):
        bench_entry.main()


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.delenv("KMER_BENCH_DEVICE", raising=False)
    monkeypatch.setattr(tb, "run_bench", lambda **kw: pytest.fail(
        "the bench ran without the card"))
    with pytest.raises(RuntimeError, match="is_available"):
        bench_entry.main()


TPU_RECORDS = ("SUSTAINED.json", "INGEST_r05.json", "INGEST_r04.json",
               "DISTCOUNT_r05.json")


def test_tpu_records_are_never_surfaced(tmp_path):
    for name in TPU_RECORDS:
        (tmp_path / name).write_text(json.dumps({"value": 1, "device": "TPU"}))
    assert bench_entry.port_records(str(tmp_path)) == {}


def test_port_records_are_surfaced(cpu_entry, monkeypatch, capsys):
    sustained = {"value": 2.0, "total_kmers": 3, "wall_s": 4.0, "distinct": 5,
                 "card": "NVIDIA H100 80GB HBM3, 700.00 W", "resume_stats": {}}
    ingest = {"big_distinct": 6}
    (cpu_entry / "SUSTAINED_torch.json").write_text(json.dumps(sustained))
    (cpu_entry / "INGEST_torch.json").write_text(json.dumps(ingest))
    for name in TPU_RECORDS:
        (cpu_entry / name).write_text("{}")
    monkeypatch.setattr(tb, "run_bench", lambda **kw: {"metric": "m",
                                                       "detail": {}})
    monkeypatch.setenv("KMER_BENCH_MODE", "fused")
    bench_entry.main()
    detail = json.loads(capsys.readouterr()[1].splitlines()[-1])["detail"]
    assert detail["sustained"] == {k: v for k, v in sustained.items()
                                   if k != "resume_stats"}
    assert detail["out_of_core_ingest"] == ingest
    assert set(detail) == {"launches", "sustained", "out_of_core_ingest"}


@pytest.mark.parametrize("name", ["SUSTAINED_torch.json",
                                  "INGEST_torch.json"])
def test_a_corrupt_port_record_raises(tmp_path, name):
    (tmp_path / name).write_text('{"value": 1')
    with pytest.raises(json.JSONDecodeError):
        bench_entry.port_records(str(tmp_path))
