"""The comparison catches a broken timed path: with each fault the cells
can have planted in the program, a run (the look for a card skipped, at
a tiny size on the CPU) comes out not correct.  Each fault is planted
where both of the program's count paths meet it: ``pipeline``'s fold
(``count_file``, ``count_batches_pipelined``) and the sharded stream's
(``parallel.dist``, ``ops.wide.fold_windows_into_wide``).  One chip and
no model here, so there is no exchange between chips to leave out."""

import time

import pytest

from benchmark.control import readings
from benchmark.harness import run_cell
from benchmark.spec import Spec

import tiny


def unchanged_state(monkeypatch):
    """The fold's step returns the accumulator as it was.  In the stream
    the first step still folds into the empty accumulator: the program's
    checkpoint of an empty accumulator raises, which would end the run
    with no result rather than with a wrong one."""
    from kmer_tpu_torch import pipeline
    from kmer_tpu_torch.ops import wide

    monkeypatch.setattr(pipeline, "merge_groups",
                        lambda a_keys, a_counts, b_keys, b_counts:
                        (a_keys, a_counts))
    real = wide.merge_groups

    def merge_groups(a_keys, a_counts, b_keys, b_counts):
        if a_keys.numel():
            return a_keys, a_counts
        return real(a_keys, a_counts, b_keys, b_counts)

    monkeypatch.setattr(wide, "merge_groups", merge_groups)


def half_batch(monkeypatch):
    """Half of each batch's rows left out of the count."""
    from kmer_tpu_torch import pipeline
    from kmer_tpu_torch.parallel import dist

    for module, name in ((pipeline, "wire_keys"), (dist, "codes_keys")):
        real = getattr(module, name)

        def keys_of(rows, *args, real=real, **kwargs):
            keys, valid = real(rows, *args, **kwargs)
            valid[valid.shape[0] // 2:] = False
            return keys, valid

        monkeypatch.setattr(module, name, keys_of)


def altered_answer(monkeypatch):
    """One count of the table off by one where the table is made."""
    from kmer_tpu_torch import pipeline
    from kmer_tpu_torch.ops import wide

    for module in (pipeline, wide):
        real = module.fit_groups

        def fit_groups(keys, counts, k, capacity, real=real):
            counts = counts.clone()
            counts[:1] += 1
            return real(keys, counts, k, capacity)

        monkeypatch.setattr(module, "fit_groups", fit_groups)


FAULTS = [unchanged_state, half_batch, altered_answer]
CELLS = [w["name"] for w in Spec().data["workloads"]]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", tiny.cells())
def test_a_planted_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result = run_cell(workload, 11, 0.1, False, "cpu", time.perf_counter(),
                      spec=tiny.spec(), config=tiny.config(workload),
                      mix=tiny.mix(workload))
    assert result["correct"] is False
    assert result["checks"]["mismatched_rows"]["value"] > 0


@pytest.mark.parametrize("workload", tiny.cells())
def test_the_control_is_not_correct(workload):
    """The reference at 32-bit keys, in the program's place, at a test
    size: every number it gives exceeds its limit of 0 or one does."""
    got = readings(workload, 2 ** 34 + 9, spec=tiny.spec(),
                   config=tiny.config(workload))
    assert got["mismatched_rows"] > 0


def test_the_sound_program_is_correct_on_the_same_runs():
    w = CELLS[0]
    result = run_cell(w, 11, 0.1, False, "cpu", time.perf_counter(),
                      config=tiny.config(w), mix=tiny.mix(w))
    assert result["correct"] is True
