"""The device rule of every public entry point: the caller names the
device, and a CUDA device without a card raises before any work, rather
than running on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device; raises if it is a CUDA device and
    ``torch.cuda.is_available()`` is False."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} was asked for, but torch.cuda.is_available() "
            "is False")
    return device
