"""2-bit codes -> k-mer keys: the wrapper of the hand-written CUDA kernel
(``csrc/codes_keys.cu``), its plain PyTorch version, and its launch count.

Replaces the device work that XLA fused on the TPU with no Pallas kernel
(``kmer_tpu/ops/extract.py`` ``extract_windows_batch`` and
``canonicalize``, composed by ``kmer_tpu/ops/count.py``,
``ops/dense_count.py`` and ``parallel/dist.py``'s halo'd blocks).

``codes_keys(codes, lengths, k, canonical)`` takes padded reads, codes
``[B, L]`` uint8 (2-bit codes 0..3, as ``Dna.codes``, ``simulate_reads``
and the streams make them), and lengths ``[B]``.  It returns ``(keys,
valid)``: keys int64 ``[B, L - k + 1]``, window i of row b the
left-aligned key of bases i .. i + k - 1 (canonical when asked), and valid
bool of the same shape, ``i <= lengths[b] - k``.  Every slot, valid or
not, equals the plain version's, which is the composition the count paths
ran before this kernel existed: ``extract_windows_batch``, then
``canonicalize``.

Codes of another dtype raise ``TypeError`` on every device: a caller with
int codes casts them once (``as_codes``).  ``keys_out`` / ``valid_out``
take contiguous ``[B, L - k + 1]`` views to write into.  The wrapper takes
the plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..codec import MAX_K
from ..errors import InvalidKmerLengthError
from ..ops.extract import canonicalize, extract_windows_batch
from .build import KernelLibrary
from .words import check_out, stream_of

MAX_LEN = 1 << 30  # bases a row may have (the kernel's 32-bit offsets)

_LIB = KernelLibrary("codes_keys", {
    "codes_keys_launch": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p],
})


def build():
    """Build (if needed) and load the kernel library."""
    return _LIB.load()


def as_codes(codes: torch.Tensor) -> torch.Tensor:
    """Codes as the kernel takes them: contiguous uint8 (2-bit codes fit;
    a no-op for codes that already are)."""
    return codes.to(torch.uint8).contiguous()


def _check(codes, lengths, k) -> int:
    """Windows a row; raises on what the kernel does not take."""
    if codes.dim() != 2:
        raise ValueError(f"codes_keys needs [B, L] codes, got "
                         f"{tuple(codes.shape)}")
    m = codes.shape[1] - k + 1
    if not 1 <= k <= MAX_K or m <= 0:
        raise InvalidKmerLengthError()
    if codes.dtype != torch.uint8:
        raise TypeError(f"codes_keys needs uint8 codes, got {codes.dtype} "
                        "(cast once with as_codes)")
    if not codes.is_contiguous():
        raise ValueError("codes_keys needs contiguous codes")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"codes_keys runs on cpu or cuda, not {codes.device}")
    if codes.shape[1] > MAX_LEN:
        raise ValueError(f"codes_keys takes rows of at most {MAX_LEN} "
                         f"bases, got {codes.shape[1]}")
    if (tuple(lengths.shape) != (codes.shape[0],)
            or lengths.device != codes.device
            or lengths.dtype.is_floating_point or lengths.dtype == torch.bool):
        raise ValueError(f"lengths must be [{codes.shape[0]}] integers on "
                         f"{codes.device}, got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    return m


def codes_keys_reference(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                         canonical: bool
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: extract the windows, canonicalize."""
    keys, valid = extract_windows_batch(codes, lengths, k)
    if canonical:
        keys = canonicalize(keys, k)
    return keys, valid


def codes_keys(codes: torch.Tensor, lengths: torch.Tensor, k: int,
               canonical: bool, keys_out: torch.Tensor | None = None,
               valid_out: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys, valid) of the module docstring, into ``keys_out`` /
    ``valid_out`` when given."""
    m = _check(codes, lengths, k)
    shape = (codes.shape[0], m)
    check_out(keys_out, torch.int64, shape, codes.device, "keys_out")
    check_out(valid_out, torch.bool, shape, codes.device, "valid_out")
    if codes.device.type == "cpu":
        keys, valid = codes_keys_reference(codes, lengths, k, canonical)
        if keys_out is not None:
            keys = keys_out.copy_(keys)
        if valid_out is not None:
            valid = valid_out.copy_(valid)
        return keys, valid
    keys = keys_out if keys_out is not None else torch.empty(
        shape, dtype=torch.int64, device=codes.device)
    valid = valid_out if valid_out is not None else torch.empty(
        shape, dtype=torch.bool, device=codes.device)
    if shape[0]:
        if lengths.dtype not in (torch.int32, torch.int64):
            lengths = lengths.to(torch.int64)
        lengths = lengths.contiguous()
        _LIB.launch("codes_keys_launch", codes.data_ptr(), shape[0],
                    codes.shape[1], k, int(canonical), lengths.data_ptr(),
                    int(lengths.dtype == torch.int64), keys.data_ptr(),
                    valid.data_ptr(), stream_of(codes))
        codes_keys.launches += 1
    return keys, valid


codes_keys.launches = 0  # kernel launches (CUDA calls only)
