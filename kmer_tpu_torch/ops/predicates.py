"""Predicates: length / equals / starts_with / contains / hash.

The counterpart of ``kmer_tpu/ops/predicates.py``.  The scalar forms
mirror the reference SQL functions one for one (kmer.c:201-285) on the
host; the ``v_*`` forms run over a ``KmerColumn`` (int64 keys, int32
lengths) on its device, each a few elementwise torch ops that a fused
pass could replace.

Argument-order quirks kept from the reference:
* ``starts_with(prefix, kmer)``: prefix FIRST (kmer.c:248-255).
* ``starts_with_op(kmer, prefix)``: the ``^@`` operator, args swapped
  (kmer.c:258-265).
* ``contains(qkmer, kmer)`` is ``@>``; ``containing(kmer, qkmer)`` is
  ``<@`` (kmer.c:268-285); both need equal lengths and a positionwise
  IUPAC match.

The hash is ``kmer_tpu``'s murmur3-style 32-bit finalizer, bit for bit.
Torch has no uint32 multiply, and the int64 product of two values under
2^32 can overflow, so ``_mix32`` keeps every value in [0, 2^32) and
splits each multiply into 16-bit halves whose products stay under 2^49.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import codec
from ..packed import KmerColumn
from ..types import Dna, Kmer, Qkmer

_U32 = 0xFFFFFFFF


# --- scalar forms (parity surface) -------------------------------------------


def length(value) -> int:
    """length(dna|kmer|qkmer): payload char count (kmer.c:201-221)."""
    if isinstance(value, (Dna, Kmer, Qkmer)):
        return len(value)
    raise TypeError(f"length() expects Dna/Kmer/Qkmer, got {type(value)!r}")


def equals(a, b) -> bool | None:
    """equals(kmer, kmer); STRICT: NULL (None) propagates."""
    if a is None or b is None:
        return None
    return Kmer(a) == Kmer(b)


def starts_with(prefix, kmer) -> bool | None:
    """starts_with(prefix, kmer): prefix is the FIRST argument."""
    if prefix is None or kmer is None:
        return None
    prefix, kmer = Kmer(prefix), Kmer(kmer)
    if len(prefix) > len(kmer):
        return False
    return bool(np.array_equal(prefix.codes, kmer.codes[: len(prefix)]))


def starts_with_op(kmer, prefix) -> bool | None:
    """kmer ^@ prefix: the same predicate, args swapped."""
    if prefix is None or kmer is None:
        return None
    return starts_with(prefix, kmer)


def _match_positionwise(qk: Qkmer, km: Kmer) -> bool:
    """kmer_query (kmer.c:59-79): equal lengths + IUPAC match everywhere."""
    if len(qk) != len(km):
        return False
    if len(qk) == 0:
        return True
    return bool(np.all((qk.masks >> km.codes) & 1))


def contains(qkmer, kmer) -> bool | None:
    """contains(qkmer, kmer) == qkmer @> kmer (kmer.c:278-285)."""
    if qkmer is None or kmer is None:
        return None
    return _match_positionwise(Qkmer(qkmer), Kmer(kmer))


def containing(kmer, qkmer) -> bool | None:
    """containing(kmer, qkmer) == kmer <@ qkmer (kmer.c:268-275)."""
    if qkmer is None or kmer is None:
        return None
    return _match_positionwise(Qkmer(qkmer), Kmer(kmer))


def kmer_hash(kmer) -> int:
    """hash(kmer) -> int32: the device hash (``v_hash``) on the host.  The
    reference's contract is only a stable hash consistent with equality
    (kmer.c:353-365)."""
    km = Kmer(kmer)
    hi, lo = km.hi_lo
    h = _hash_finalize_np(np.asarray([hi], np.uint32),
                          np.asarray([lo], np.uint32),
                          np.asarray([len(km)], np.int32))[0]
    return int(np.int32(h))


# --- vectorized forms (device path) ------------------------------------------


def _prefix_mask(p: torch.Tensor) -> torch.Tensor:
    """int64 mask of the top 2p bits of a key, for p in [0, 32]."""
    shift = (64 - 2 * p.to(torch.int64)).clamp(max=62)
    return torch.where(p == 0, 0, -(torch.ones_like(shift) << shift))


def v_equals(col: KmerColumn, other: KmerColumn) -> torch.Tensor:
    """Elementwise kmer equality (a 0-dim probe broadcasts over a column)."""
    return (col.key == other.key) & (col.length == other.length)


def v_starts_with(col: KmerColumn, prefix: KmerColumn) -> torch.Tensor:
    """Elementwise ``col ^@ prefix``: the first len(prefix) bases equal and
    len(col) >= len(prefix)."""
    plen = torch.as_tensor(prefix.length, device=col.key.device)
    ok = (col.key & _prefix_mask(plen)) == prefix.key
    return ok & (col.length >= plen)


def v_contains(col: KmerColumn, qmasks, qlen: int) -> torch.Tensor:
    """Elementwise ``qkmer @> col``: equal length and a positionwise IUPAC
    match.  qmasks: [MAX_K] 4-bit masks (anything past qlen is ignored)."""
    ok = col.length == qlen
    for i in range(int(qlen)):
        code = (col.key >> (62 - 2 * i)) & 3
        ok = ok & (((int(qmasks[i]) >> code) & 1) != 0)
    return ok


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): the high half of c only
    reaches the result through the low 16 bits of its product."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_u32(key: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """The 32-bit hash of (key, length) as int64 values in [0, 2^32)."""
    hi = (key >> 32) & _U32
    lo = key & _U32
    h = _mix32(hi ^ 0x9E3779B9)
    h = _mix32(h ^ lo)
    return _mix32(h ^ (length.to(torch.int64) & _U32))


def as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors with the same bits."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def v_hash(col: KmerColumn) -> torch.Tensor:
    """Vectorized 32-bit hash of packed kmers, int32, bit-equal to
    ``_hash_finalize_np``."""
    return as_int32_bits(hash_u32(col.key, col.length))


def _mix32_np(x):
    x = np.asarray(x, np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
    x = x ^ (x >> np.uint32(13))
    x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
    return x ^ (x >> np.uint32(16))


def _hash_finalize_np(hi, lo, length):
    h = _mix32_np(np.asarray(hi, np.uint32) ^ np.uint32(0x9E3779B9))
    h = _mix32_np(h ^ np.asarray(lo, np.uint32))
    return _mix32_np(h ^ np.asarray(length, np.int32).astype(np.uint32))


def qkmer_mask_vector(qkmer) -> tuple[np.ndarray, int]:
    """Qkmer -> ([MAX_K] uint32 mask vector, qlen) for v_contains."""
    qk = Qkmer(qkmer)
    out = np.zeros(codec.MAX_K, dtype=np.uint32)
    out[: len(qk)] = qk.masks
    return out, len(qk)
