"""After a run, no loaded module's top-level name is ``jax``, ``jaxlib``,
``flax`` or the JAX package's ``kmer_tpu``; ``kmer_tpu_torch``, whose
name starts with it, passes.  In a fresh process, so that nothing the
test process loaded counts."""

import os
import subprocess
import sys

import pytest

from benchmark.harness import FORBIDDEN, forbidden_modules

import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SCRIPT = r"""
import sys, time, json
sys.path.insert(0, "benchmark/tests")
import tiny
from benchmark.harness import run_cell, forbidden_modules
w = sys.argv[1]
r = run_cell(w, 5, 0.1, True, "cpu", time.perf_counter(), spec=tiny.spec(),
             config=tiny.config(w), mix=tiny.mix(w))
assert r["correct"], r
assert "kmer_tpu_torch" in sys.modules
print(json.dumps(forbidden_modules()))
"""


@pytest.mark.parametrize("workload", tiny.cells())
def test_a_run_loads_no_jax_nor_the_jax_package(workload):
    out = subprocess.run([sys.executable, "-c", SCRIPT, workload], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_names_are_compared_whole(monkeypatch):
    for name in ("kmer_tpu_torch", "kmer_tpu_torch.pipeline", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not [m for m in forbidden_modules()
                if m.split(".")[0] not in FORBIDDEN]
    for name in ("kmer_tpu", "kmer_tpu.pipeline", "jax.numpy"):
        monkeypatch.setitem(sys.modules, name, sys)
        assert name in forbidden_modules()
