"""On the card: one short run of each cell at a tiny size through the
harness, correct, with every per-layer metric read from the trace.
Skips without a CUDA card."""

import time

import pytest
import torch

from benchmark.harness import run_cell

import tiny


@pytest.mark.gpu
@pytest.mark.parametrize("workload", tiny.cells())
def test_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = tiny.spec()
    result = run_cell(workload, 2 ** 33 + 3, 0.5, True, "cuda",
                      time.perf_counter(), spec=spec,
                      config=tiny.config(workload), mix=tiny.mix(workload))
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    names = {m["name"] for m in spec.metrics(spec.workload(workload), True)}
    assert set(result["metrics"]) == names
