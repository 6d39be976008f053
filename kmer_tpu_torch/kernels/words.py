"""32-bit words in torch tensors, as the probe kernels take them.

The kernels move 32-bit words as bits, so an int32, uint32 or float32
tensor takes the same path.  torch's uint32 has no shifts, no ``max`` and
no ``flip``, so the plain versions work on int64 copies that hold each
word's unsigned value (``to_u32``) and turn them back into words of the
caller's dtype at the end (``from_u32``); ``+ 1`` then wraps mod 2^32 by
masking.
"""

from __future__ import annotations

import torch

WORD_DTYPES = (torch.int32, torch.uint32, torch.float32)
MASK32 = 0xFFFFFFFF


def check_words(x: torch.Tensor, what: str, dim: int | None = 2) -> None:
    """Raises unless ``x`` is a contiguous tensor of 32-bit words on the
    CPU or a CUDA device, with ``dim`` dimensions (any if None)."""
    if x.dtype not in WORD_DTYPES:
        raise TypeError(f"{what} needs 32-bit words (int32, uint32 or "
                        f"float32), got {x.dtype}")
    if dim is not None and x.dim() != dim:
        raise ValueError(f"{what} needs a {dim}-D tensor, got {x.dim()}-D")
    if not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")


def check_out(out: torch.Tensor | None, dtype: torch.dtype, shape: tuple,
              device: torch.device, name: str) -> None:
    """Raises unless ``out`` (a caller's output buffer, or None) is a
    contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if out is None:
        return
    if (out.dtype != dtype or tuple(out.shape) != shape
            or not out.is_contiguous() or out.device != device):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {shape} on {device}")


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """32-bit words -> int64 holding their unsigned values."""
    return x.view(torch.int32).to(torch.int64) & MASK32


def from_u32(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 unsigned values (any bits above 31 dropped) -> words of
    ``dtype`` with those bits."""
    return (v & MASK32).to(torch.int32).view(dtype)


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int."""
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream
