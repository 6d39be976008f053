"""The comparison catches a broken timed path: with each fault the cells
can have planted in the program, a run (the look for a card skipped, at
a tiny size on the CPU) comes out not correct.  One chip and no model
here, so there is no exchange between chips to leave out."""

import time

import pytest

from benchmark.control import readings
from benchmark.harness import run_cell
from benchmark.spec import Spec

import tiny


def unchanged_state(monkeypatch):
    """The fold's step returns the accumulator as it was."""
    from kmer_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "merge_groups",
                        lambda a_keys, a_counts, b_keys, b_counts:
                        (a_keys, a_counts))


def half_batch(monkeypatch):
    """Half of each batch's rows left out of the count."""
    from kmer_tpu_torch import pipeline

    real = pipeline.wire_keys

    def wire_keys(wire, *args, **kwargs):
        keys, valid = real(wire, *args, **kwargs)
        valid[valid.shape[0] // 2:] = False
        return keys, valid

    monkeypatch.setattr(pipeline, "wire_keys", wire_keys)


def altered_answer(monkeypatch):
    """One count of the table off by one where the table is made."""
    from kmer_tpu_torch import pipeline

    real = pipeline.fit_groups

    def fit_groups(keys, counts, k, capacity):
        counts = counts.clone()
        counts[:1] += 1
        return real(keys, counts, k, capacity)

    monkeypatch.setattr(pipeline, "fit_groups", fit_groups)


FAULTS = [unchanged_state, half_batch, altered_answer]
CELLS = [w["name"] for w in Spec().data["workloads"]]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = run_cell(workload, 11, 0.1, False, "cpu", time.perf_counter(),
                      config=tiny.config(workload), mix=tiny.MIX[workload])
    assert result["correct"] is False
    assert result["checks"]["mismatched_rows"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    """The reference at 32-bit keys, in the program's place, at a test
    size: every number it gives exceeds its limit of 0 or one does."""
    got = readings(workload, 2 ** 34 + 9, config=tiny.config(workload))
    assert got["mismatched_rows"] > 0


def test_the_sound_program_is_correct_on_the_same_runs():
    w = CELLS[0]
    result = run_cell(w, 11, 0.1, False, "cpu", time.perf_counter(),
                      config=tiny.config(w), mix=tiny.MIX[w])
    assert result["correct"] is True
