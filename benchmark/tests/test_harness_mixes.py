"""Each cell runs end to end at a tiny size on the CPU through the
harness, plain and traced, and is correct; the command itself refuses to
run without a CUDA card."""

import os
import subprocess
import sys
import time

import pytest

from benchmark.harness import run_cell
from benchmark.spec import Spec

import tiny

CELLS = [w["name"] for w in Spec().data["workloads"]]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", tiny.cells())
def test_cell_runs_end_to_end_on_the_cpu(workload, traced):
    spec = tiny.spec()
    result = run_cell(workload, 2 ** 33 + 17, 0.2, traced, "cpu",
                      time.perf_counter(), spec=spec,
                      config=tiny.config(workload), mix=tiny.mix(workload))
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert all(c["value"] == 0 == c["limit"]
               for c in result["checks"].values())
    names = {m["name"] for m in spec.metrics(spec.workload(workload),
                                             traced=traced)}
    if traced:  # on the CPU only the host's readings exist
        assert set(result["metrics"]) <= names
        assert "trim_s_per_job" in result["metrics"]
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == names
        assert result["metrics"]["kmers_per_s"]["value"] > 0


def test_the_command_refuses_without_a_card():
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA card" in out.stderr
