"""Phase timing with trace annotations.

The counterpart of ``kmer_tpu/utils/profiling.py``: each phase is a
``torch.profiler.record_function`` range, so it shows up by name in a
``torch.profiler`` trace, and its host-clock time (and optional byte
count) accumulates in a ``Profile``.
"""

from __future__ import annotations

import contextlib
import time

import torch


class Profile:
    """Accumulates per-phase wall time and optional byte counts."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self.bytes: dict[str, int] = {}


def synchronize(x) -> None:
    """Waits for the CUDA device of tensor ``x`` (or device ``x``); a CPU
    tensor or device needs no wait."""
    device = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase_timer(profile: Profile | None, name: str, nbytes: int = 0,
                sync=None):
    """Times a phase and annotates the trace.  With ``sync`` (a tensor or a
    device), the clock starts and stops only after that CUDA device has
    finished its queued work, so the time covers the device work."""
    with torch.profiler.record_function(name):
        if sync is not None:
            synchronize(sync)
        t0 = time.perf_counter()
        yield
        if sync is not None:
            synchronize(sync)
        dt = time.perf_counter() - t0
    if profile is not None:
        profile.phases[name] = profile.phases.get(name, 0.0) + dt
        if nbytes:
            profile.bytes[name] = profile.bytes.get(name, 0) + nbytes
