"""What the probe families share: the result record, timing, comparison."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..kernels.words import to_u32


@dataclasses.dataclass
class Record:
    """One probe's outcome.

    ``correct``: the wrapper's result equals the plain version's and, where
    the probe script had one, its numpy oracle.  ``device``: where it ran;
    on the CPU the wrapper is the plain version and no time is a device
    time.  ``max_abs_err``: the
    largest difference between wrapper and plain version, word for word,
    as unsigned 32-bit integers.  ``ms`` / ``plain_ms``: one call of the
    wrapper / of the plain version (on the CPU the wrapper is the plain
    version).  ``ops`` is the script's operation count for a rate (stages
    times words) and ``copies`` / ``nbytes`` the copies and bytes moved
    (read + write) for a copy family.
    """

    name: str
    family: str
    kernel: str
    site: str  # the script's pallas_call this probe stands for
    device: str
    correct: bool
    max_abs_err: int
    ms: float
    plain_ms: float
    ops: int | None = None
    copies: int | None = None
    nbytes: int | None = None

    def line(self) -> str:
        """The human-readable line the probe prints."""
        who = "kernel" if self.device.startswith("cuda") else "wrapper"
        if self.family == "capability":
            return (f"{self.name}: OK correct: {self.correct}  "
                    f"({who} {self.ms:.4f} ms, plain {self.plain_ms:.4f} ms)")
        parts = [f"{self.name}: correct: {self.correct}"]
        for who, ms in ((who, self.ms), ("plain", self.plain_ms)):
            s = f"{who} {ms:.4f} ms"
            if self.ops:
                s += f" -> {self.ops / ms / 1e6:.3f} G ops/s"
            if self.copies:
                s += (f" -> {self.copies / ms * 1e3:.1f} copies/s, "
                      f"{self.nbytes / ms / 1e6:.3f} GB/s")
            parts.append(s)
        return "; ".join(parts)


def time_ms(fn: Callable[[], object], device: torch.device,
            iters: int) -> float:
    """Mean ms of one ``fn()`` call, warm: CUDA events around ``iters``
    calls on a card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def words(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array of 32-bit words on ``device``; uint32 travels as
    int32 bits (torch's uint32 has few operators)."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def host(t: torch.Tensor, dtype=np.uint32) -> np.ndarray:
    """A tensor of 32-bit words as a numpy array of ``dtype``."""
    return t.contiguous().cpu().numpy().view(dtype)


def max_abs_err(a, b) -> int:
    """Largest word-for-word difference of two word arrays (tensors, or
    tuples of tensors) as unsigned 32-bit integers, computed on their
    device."""
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} "
                         "differ")
    if a.numel() == 0:
        return 0
    return int((to_u32(a) - to_u32(b)).abs().max())
