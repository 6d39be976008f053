"""Packed words -> k-mer keys: the wrappers of the two hand-written CUDA
kernels of ``csrc/wire_keys.cu`` (``wire_keys`` for the wire of rows,
``stream_keys`` for a phase-major word stream), their plain PyTorch
versions, and their launch counts.

Replaces the device work that XLA fused on the TPU with no Pallas kernel
(``kmer_tpu/native.py`` ``device_unpack_rows``, ``kmer_tpu/ops/extract.py``
``extract_windows_batch`` and ``canonicalize``, composed per batch by
``kmer_tpu/pipeline.py``).

``wire_keys(wire, width, k, canonical)`` takes an uploaded wire array,
``[B, nw (+1)]`` uint32 words as int32 bits: a row's first
``nw = ceil(width / 16)`` words hold its bases (base j at bits
``30 - 2 * (j % 16)`` of word ``j // 16``) and, with ``lengths`` (the
pipeline's form), the last column holds the row's length.  It returns
``(keys, valid)``: keys int64 ``[B, width - k + 1]``, window i of row b
the left-aligned key of bases i .. i + k - 1 (canonical when asked), and
valid bool of the same shape, ``i <= length - k`` (None without
``lengths``).  Every slot, valid or not, equals the plain version's, which
is the composition the pipeline ran before this kernel existed:
``device_unpack_rows``, ``extract_windows_batch``, ``canonicalize``.

``keys_out`` / ``valid_out`` take contiguous ``[B, width - k + 1]`` views
(a batch's slice of a flat buffer) to write into.  The wrapper takes the
plain version only for a tensor on the CPU; for a CUDA tensor it launches
the kernel or raises.

``stream_keys(words, k, canonical, read_len, n_reads)`` replaces the XLA
fusion of ``kmer_tpu/ops/extract.py`` ``extract_from_words``,
``canonicalize`` and ``phase_major_valid`` (composed by
``kmer_tpu/bench.py``'s stream and chr benches).  It takes a flat stream
of ``nw`` 32-bit words (int32 or uint32), reads of ``read_len`` bases laid
back to back, and returns ``(keys, valid)``, ``[16, nw]`` each: keys[r, w]
the window at base p = 16w + r (canonical when asked; windows past the
stream's end read zero words) and valid[r, w] ``p % read_len <= read_len
- k`` and ``p <= n_reads * read_len - k``.  Every slot equals the plain
version's: ``extract_from_words``, ``canonicalize``,
``phase_major_valid``.
"""

from __future__ import annotations

import ctypes

import torch

from ..codec import MAX_K
from ..errors import InvalidKmerLengthError
from ..native import device_unpack_rows
from ..ops.extract import (
    canonicalize, extract_from_words, extract_windows_batch,
    phase_major_valid)
from .build import KernelLibrary
from .words import MASK32, check_out, stream_of

MAX_STAGED = 8192  # wire words a row may have (kMaxStaged in the source)

_LIB = KernelLibrary("wire_keys", {
    "wire_keys_launch": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p],
    "stream_keys_launch": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p],
})


def build():
    """Build (if needed) and load the kernel library."""
    return _LIB.load()


def _check(wire, width, k, lengths) -> tuple[int, int]:
    """(base words a row, windows a row); raises on what the kernel does
    not take."""
    if not 1 <= k <= MAX_K or width < k:
        raise InvalidKmerLengthError()
    if wire.dtype != torch.int32:
        raise TypeError(f"wire_keys needs int32 words, got {wire.dtype}")
    if wire.dim() != 2 or not wire.is_contiguous():
        raise ValueError("wire_keys needs a contiguous 2-D wire")
    if wire.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wire_keys runs on cpu or cuda, not {wire.device}")
    nw = -(-width // 16)
    if wire.shape[1] != nw + int(lengths) or wire.shape[1] > MAX_STAGED:
        raise ValueError(
            f"a wire of width {width} has {nw} base words"
            f"{' and a length column' if lengths else ''} (at most "
            f"{MAX_STAGED} words), got {wire.shape[1]} columns")
    return nw, width - k + 1


def wire_keys_reference(wire: torch.Tensor, width: int, k: int,
                        canonical: bool, lengths: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version: unpack every base to an int64 code, extract
    the windows, canonicalize."""
    nw, _ = _check(wire, width, k, lengths)
    wire64 = wire.to(torch.int64) & MASK32
    codes = device_unpack_rows(wire64[:, :nw], width)
    lens = wire64[:, nw] if lengths else torch.full(
        (wire.shape[0],), width, dtype=torch.int64, device=wire.device)
    keys, valid = extract_windows_batch(codes, lens, k)
    if canonical:
        keys = canonicalize(keys, k)
    return keys, valid if lengths else None


def wire_keys(wire: torch.Tensor, width: int, k: int, canonical: bool,
              lengths: bool = True, keys_out: torch.Tensor | None = None,
              valid_out: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(keys, valid) of the module docstring, into ``keys_out`` /
    ``valid_out`` when given."""
    _, m = _check(wire, width, k, lengths)
    shape = (wire.shape[0], m)
    check_out(keys_out, torch.int64, shape, wire.device, "keys_out")
    if valid_out is not None and not lengths:
        raise ValueError("valid_out needs the wire's length column")
    check_out(valid_out, torch.bool, shape, wire.device, "valid_out")
    if wire.device.type == "cpu":
        keys, valid = wire_keys_reference(wire, width, k, canonical, lengths)
        if keys_out is not None:
            keys = keys_out.copy_(keys)
        if valid_out is not None:
            valid = valid_out.copy_(valid)
        return keys, valid
    keys = keys_out if keys_out is not None else torch.empty(
        shape, dtype=torch.int64, device=wire.device)
    valid = None
    if lengths:
        valid = valid_out if valid_out is not None else torch.empty(
            shape, dtype=torch.bool, device=wire.device)
    if shape[0]:
        _LIB.launch("wire_keys_launch", wire.data_ptr(), shape[0],
                    wire.shape[1], width, k, int(canonical), int(lengths),
                    keys.data_ptr(), None if valid is None else
                    valid.data_ptr(), stream_of(wire))
        wire_keys.launches += 1
    return keys, valid


wire_keys.launches = 0  # kernel launches (CUDA calls only)


def _check_stream(words, k, read_len, n_reads) -> None:
    if not 1 <= k <= MAX_K:
        raise InvalidKmerLengthError()
    if words.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"stream_keys needs 32-bit words (int32 or uint32),"
                        f" got {words.dtype}")
    if words.dim() != 1 or not words.is_contiguous():
        raise ValueError("stream_keys needs a contiguous 1-D word stream")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stream_keys runs on cpu or cuda, not "
                         f"{words.device}")
    if read_len < 1 or n_reads < 0:
        raise ValueError(f"stream_keys needs read_len >= 1 and n_reads >= "
                         f"0, got {read_len} and {n_reads}")


def stream_keys_reference(words: torch.Tensor, k: int, canonical: bool,
                          read_len: int, n_reads: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the 16 phases' windows, canonicalized, and
    ``phase_major_valid``."""
    _check_stream(words, k, read_len, n_reads)
    keys = extract_from_words(words.view(torch.int32), k)
    if canonical:
        keys = canonicalize(keys, k)
    return keys, phase_major_valid(words.numel(), read_len, n_reads, k,
                                   words.device)


def stream_keys(words: torch.Tensor, k: int, canonical: bool,
                read_len: int, n_reads: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys, valid) [16, nw] of the module docstring."""
    if words.device.type == "cpu":
        return stream_keys_reference(words, k, canonical, read_len, n_reads)
    _check_stream(words, k, read_len, n_reads)
    nw = words.numel()
    keys = torch.empty((16, nw), dtype=torch.int64, device=words.device)
    valid = torch.empty((16, nw), dtype=torch.bool, device=words.device)
    if nw:
        _LIB.launch("stream_keys_launch", words.data_ptr(), nw, k,
                    int(canonical), int(read_len), int(n_reads),
                    keys.data_ptr(), valid.data_ptr(), stream_of(words))
        stream_keys.launches += 1
    return keys, valid


stream_keys.launches = 0  # kernel launches (CUDA calls only)
