"""Packed k-mer keys: the int64 device layout and the host container.

``kmer_tpu`` holds a key as two uint32 lanes ``(hi, lo)``.  PyTorch has no
usable uint32 (no shifts, no max), so the port holds the same 64 bits in
one int64: ``key = (hi << 32) | lo``, base ``j`` at bits ``62-2j``.

Key order is *unsigned* (string order equals ``(hi, lo, length)`` order),
but torch compares int64 as signed.  XOR with ``SIGN_FLIP`` maps unsigned
order onto signed order, so sorts and minimums run on flipped keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import codec

SIGN_FLIP = -(1 << 63)  # key ^ SIGN_FLIP: unsigned key order as int64 order


def as_int64(value: int) -> int:
    """A 64-bit pattern given as an unsigned Python int, as a signed one."""
    value = int(value)
    return value - (1 << 64) if value >= 1 << 63 else value


def key_from_hi_lo(hi, lo) -> np.ndarray:
    """(hi, lo) uint32 lanes -> int64 keys with the same 64 bits."""
    return codec.join_key64(hi, lo).view(np.int64)


def hi_lo_from_key(keys) -> tuple[np.ndarray, np.ndarray]:
    """int64 keys -> (hi, lo) uint32 lanes."""
    u = np.ascontiguousarray(keys, dtype=np.int64).view(np.uint64)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


@dataclasses.dataclass(frozen=True)
class PackedKmers:
    """N packed kmers as host (hi, lo, length) numpy arrays."""

    hi: np.ndarray
    lo: np.ndarray
    length: np.ndarray

    def __getitem__(self, idx) -> "PackedKmers":
        return PackedKmers(hi=self.hi[idx], lo=self.lo[idx],
                           length=self.length[idx])

    def to_strings(self) -> list[str]:
        keys = codec.join_key64(self.hi, self.lo)
        ln = np.asarray(self.length)
        return [
            codec.decode_codes(codec.unpack_key64(keys[i], int(ln[i])))
            for i in range(keys.size)
        ]
