"""Scalar value types: Dna, Kmer, Qkmer (host side, numpy).

The port's copy of ``kmer_tpu/types.py``, the engine's counterparts of the
reference's varlena SQL types (kmer.h:8-15, kmer.c:84-199).  Dna and Kmer
hold 2-bit codes, Qkmer 4-bit IUPAC masks; ``str()`` is the type's output
function and always prints lowercase.

* dna/kmer accept only [AaCcGgTt]; qkmer adds u,r,y,k,m,s,w,b,d,h,v,n.
* kmer/qkmer are capped at 32 chars (length checked *before* alphabet).
* Empty strings are valid values of all three types; length('') == 0.
"""

from __future__ import annotations

import numpy as np

from . import codec
from .codec import MAX_K
from .errors import KmerTooLongError


class Dna:
    """Unbounded DNA sequence (reference type ``dna``, kmer.c:84-106)."""

    __slots__ = ("codes",)

    def __init__(self, value):
        if isinstance(value, Dna):
            self.codes = value.codes
        elif isinstance(value, np.ndarray) and value.dtype == np.uint8:
            self.codes = value
        else:
            self.codes = codec.encode_dna(value)

    @classmethod
    def from_codes(cls, codes: np.ndarray) -> "Dna":
        out = cls.__new__(cls)
        out.codes = np.asarray(codes, dtype=np.uint8)
        return out

    def __len__(self) -> int:
        return int(self.codes.size)

    def __str__(self) -> str:
        return codec.decode_codes(self.codes)

    def __repr__(self) -> str:
        return f"Dna('{self}')"

    def __eq__(self, other) -> bool:
        if not isinstance(other, Dna):
            other = Dna(other)
        return self.codes.size == other.codes.size and bool(
            np.array_equal(self.codes, other.codes))

    def __hash__(self) -> int:
        return hash(("dna", self.codes.tobytes()))


class Kmer:
    """Bounded k-mer, 0 <= len <= 32 (reference type ``kmer``, kmer.c:109-138)."""

    __slots__ = ("codes",)

    def __init__(self, value):
        if isinstance(value, Kmer):
            self.codes = value.codes
        elif isinstance(value, np.ndarray) and value.dtype == np.uint8:
            if value.size > MAX_K:
                raise KmerTooLongError()
            self.codes = value
        else:
            self.codes = codec.encode_kmer(value)

    @classmethod
    def from_codes(cls, codes: np.ndarray) -> "Kmer":
        out = cls.__new__(cls)
        out.codes = np.asarray(codes, dtype=np.uint8)
        return out

    @classmethod
    def from_key64(cls, key: np.uint64, length: int) -> "Kmer":
        return cls.from_codes(codec.unpack_key64(key, length))

    @property
    def key64(self) -> np.uint64:
        """Left-aligned packed 64-bit key (codec.pack_key64)."""
        return codec.pack_key64(self.codes)

    @property
    def hi_lo(self):
        return codec.split_key64(self.key64)

    def __len__(self) -> int:
        return int(self.codes.size)

    def __str__(self) -> str:
        return codec.decode_codes(self.codes)

    def __repr__(self) -> str:
        return f"Kmer('{self}')"

    def __eq__(self, other) -> bool:
        """Value equality == the reference's `=` operator (kmer.c:226-245)."""
        if not isinstance(other, Kmer):
            other = Kmer(other)
        return self.codes.size == other.codes.size and bool(
            np.array_equal(self.codes, other.codes))

    def __hash__(self) -> int:
        return hash(("kmer", self.codes.tobytes()))


class Qkmer:
    """IUPAC query pattern, 0 <= len <= 32 (reference type ``qkmer``, kmer.c:141-199)."""

    __slots__ = ("masks",)

    def __init__(self, value):
        if isinstance(value, Qkmer):
            self.masks = value.masks
        else:
            self.masks = codec.encode_qkmer(value)

    @classmethod
    def from_masks(cls, masks: np.ndarray) -> "Qkmer":
        out = cls.__new__(cls)
        out.masks = np.asarray(masks, dtype=np.uint8)
        return out

    def __len__(self) -> int:
        return int(self.masks.size)

    def __str__(self) -> str:
        return codec.decode_masks(self.masks)

    def __repr__(self) -> str:
        return f"Qkmer('{self}')"

    def __eq__(self, other) -> bool:
        if not isinstance(other, Qkmer):
            other = Qkmer(other)
        return self.masks.size == other.masks.size and bool(
            np.array_equal(self.masks, other.masks))

    def __hash__(self) -> int:
        return hash(("qkmer", self.masks.tobytes()))

    def leading_exact_codes(self) -> np.ndarray:
        """Codes of the longest determinate (single-nucleotide) leading
        run: the prefix an index search prunes to (the SP-GiST
        inner_consistent pruning, kmer_spgist.c:395-444)."""
        out = []
        for m in self.masks:
            if not codec.is_exact_mask(int(m)):
                break
            out.append(codec.exact_mask_to_code(int(m)))
        return np.array(out, dtype=np.uint8)
