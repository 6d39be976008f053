"""A configuration, a mix and a per-layer metric are found by name: a
temporary copy of the benchmark with one file of each added, and an entry
for each in its BENCHMARK.json, runs with no file of the harness edited."""

import json
import os
import shutil
import time

from benchmark.harness import run_cell
from benchmark.spec import Spec

import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

METRIC = '''
def read(run):
    return float(len(run.jobs))
'''


def test_added_files_are_found_by_name(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: (tmp_path / "benchmark" / p).read_bytes()
              for p in ("harness.py", "spec.py", "run.py", "trace.py")}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = {**json.loads((tmp_path / "benchmark" / "configs"
                         / "scer-wgs-k21.json").read_text()),
           **tiny.sizes("scer-wgs-k21"), "name": "dummy-reads", "k": 17}
    (tmp_path / "benchmark" / "configs" / "dummy-reads.json").write_text(
        json.dumps(cfg))
    (tmp_path / "benchmark" / "mixes" / "dummy-wire.json").write_text(
        json.dumps({"input": "wire", "width": 176, "batch": 64,
                    "options": {"capacity": 64}}))
    (tmp_path / "benchmark" / "metrics" / "jobs_seen.py").write_text(METRIC)
    bench["configs"].append({"name": "dummy-reads", "source": "a test",
                             "file": "benchmark/configs/dummy-reads.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy-reads.dummy-wire",
                               "config": "dummy-reads",
                               "traffic": "dummy-wire", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "jobs_seen", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "kmers_per_s",
                               "workloads": ["dummy-reads.dummy-wire"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(str(tmp_path))
    result = run_cell("dummy-reads.dummy-wire", 3, 0.1, True, "cpu",
                      time.perf_counter(), spec=spec)
    assert result["correct"] is True
    assert result["metrics"]["jobs_seen"]["value"] == result["attempted"]
    assert {p: (tmp_path / "benchmark" / p).read_bytes()
            for p in before} == before
