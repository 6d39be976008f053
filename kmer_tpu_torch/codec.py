"""ASCII <-> 2-bit codec for DNA and k-mer keys (host side, numpy).

The port's copy of the parts of ``kmer_tpu/codec.py`` the count path
needs; ``kmer_tpu`` cannot be imported without JAX.

* A nucleotide is a 2-bit code: a=0, c=1, g=2, t=3, the byte order of the
  lowercase letters, so string order equals integer order.
* A k-mer (k <= 32) packs left-aligned into a 64-bit key: base ``i`` sits
  at bits ``[62-2i, 63-2i]``; unused low bits are zero.  ``kmer_tpu``
  carries it as two uint32 lanes ``(hi, lo)``; the port carries it as one
  int64 with the same bits (see ``packed.py``).
"""

from __future__ import annotations

import numpy as np

from .errors import InvalidDnaSequenceError

MAX_K = 32

# ASCII -> 2-bit code; -1 for invalid characters.
CODE_LUT = np.full(256, -1, dtype=np.int8)
for _i, _ch in enumerate("acgt"):
    CODE_LUT[ord(_ch)] = _i
    CODE_LUT[ord(_ch.upper())] = _i

# 2-bit code -> ASCII (always lowercase, as the reference prints).
CODE_TO_CHAR = np.frombuffer(b"acgt", dtype=np.uint8)


def _to_bytes(seq) -> bytes:
    if isinstance(seq, bytes):
        return seq
    if isinstance(seq, str):
        return seq.encode("ascii", errors="replace")
    if isinstance(seq, np.ndarray) and seq.dtype == np.uint8:
        return seq.tobytes()
    raise TypeError(f"expected str/bytes, got {type(seq)!r}")


def encode_dna(seq) -> np.ndarray:
    """Validate + encode a DNA string to 2-bit codes (uint8 array).

    Any character outside [AaCcGgTt] raises InvalidDnaSequenceError; empty
    input returns a zero-length array.
    """
    raw = np.frombuffer(_to_bytes(seq), dtype=np.uint8)
    codes = CODE_LUT[raw]
    if codes.size and codes.min() < 0:
        raise InvalidDnaSequenceError()
    return codes.astype(np.uint8)


def decode_codes(codes: np.ndarray) -> str:
    """2-bit codes -> lowercase string."""
    codes = np.asarray(codes, dtype=np.uint8)
    return CODE_TO_CHAR[codes].tobytes().decode("ascii")


def join_key64(hi, lo) -> np.ndarray:
    """(hi, lo) uint32 -> uint64 key (elementwise over arrays)."""
    hi = np.asarray(hi, dtype=np.uint64)
    lo = np.asarray(lo, dtype=np.uint64)
    return (hi << np.uint64(32)) | lo


def unpack_key64(key: np.uint64, length: int) -> np.ndarray:
    """Left-aligned uint64 key -> 2-bit codes array of the given length."""
    key = np.uint64(key)
    shifts = np.uint64(62) - np.uint64(2) * np.arange(length, dtype=np.uint64)
    return ((key >> shifts) & np.uint64(3)).astype(np.uint8)
