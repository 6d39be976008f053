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
from typing import Iterable

import numpy as np
import torch

from . import codec
from .types import Kmer

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

    def __len__(self) -> int:
        return int(self.hi.shape[-1]) if self.hi.ndim else 1

    @classmethod
    def from_strings(cls, seqs: Iterable[str]) -> "PackedKmers":
        """Kmer strings (validated as ``Kmer`` literals) -> columns."""
        codes, lengths = codec.strings_to_padded_codes(
            list(seqs), width=codec.MAX_K, encoder=codec.encode_kmer)
        key64, lengths = codec.pack_batch(codes, lengths)
        hi, lo = hi_lo_from_key(key64.view(np.int64))
        return cls(hi=hi, lo=lo, length=lengths)

    @classmethod
    def from_kmers(cls, kmers: Iterable[Kmer]) -> "PackedKmers":
        kmers = list(kmers)
        n = len(kmers)
        hi = np.zeros(n, dtype=np.uint32)
        lo = np.zeros(n, dtype=np.uint32)
        ln = np.zeros(n, dtype=np.int32)
        for i, km in enumerate(kmers):
            hi[i], lo[i] = km.hi_lo
            ln[i] = len(km)
        return cls(hi=hi, lo=lo, length=ln)

    @classmethod
    def single(cls, kmer: Kmer) -> "PackedKmers":
        return cls.from_kmers([kmer])

    def key64(self) -> np.ndarray:
        """Combined uint64 keys (for numpy sorts and searchsorted)."""
        return codec.join_key64(self.hi, self.lo)

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

    def to_kmers(self) -> list[Kmer]:
        return [Kmer(s) for s in self.to_strings()]


def concat(columns: Iterable[PackedKmers]) -> PackedKmers:
    cols = list(columns)
    return PackedKmers(hi=np.concatenate([c.hi for c in cols]),
                       lo=np.concatenate([c.lo for c in cols]),
                       length=np.concatenate([c.length for c in cols]))


@dataclasses.dataclass(frozen=True)
class KmerColumn:
    """N packed kmers on a device: ``key`` int64 with the bits of
    ``(hi << 32) | lo`` (not flipped) and ``length`` int32.  0-dim
    tensors make a single probe that broadcasts against a column."""

    key: torch.Tensor
    length: torch.Tensor

    def __len__(self) -> int:
        return int(self.key.shape[-1]) if self.key.dim() else 1

    @classmethod
    def from_packed(cls, packed: PackedKmers, device) -> "KmerColumn":
        key = key_from_hi_lo(packed.hi, packed.lo)
        return cls(key=torch.from_numpy(key).to(device),
                   length=torch.from_numpy(
                       np.asarray(packed.length, np.int32)).to(device))

    def __getitem__(self, idx) -> "KmerColumn":
        return KmerColumn(key=self.key[idx], length=self.length[idx])
