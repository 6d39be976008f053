"""Helpers shared by the CPU tests of the phase probes and the matrix-unit
rates: a module fixture that keeps torch on one thread, and the digest of
a ``kmer_tpu`` table's live rows in the probes' own form."""

import numpy as np
import pytest
import torch

from kmer_tpu_torch.probes.common import rows_digest


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, here and in child processes: the inputs are small,
    and the other test files' workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(threads)


def jax_digest(table) -> dict:
    """``rows_digest`` of a ``kmer_tpu`` CountTable's or WideCounts'
    live rows."""
    t = table.trim()
    counts = (t.counts64() if hasattr(t, "counts64")
              else np.asarray(t.counts, np.int64))
    return rows_digest(np.asarray(t.hi), np.asarray(t.lo),
                       np.asarray(t.length), counts)
