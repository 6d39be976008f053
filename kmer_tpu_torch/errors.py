"""Error types with the reference extension's exact user-facing messages.

The same classes and strings as ``kmer_tpu/errors.py``, so both packages
raise identical errors: the strings are observable behavior pinned by the
reference's test suite (``kmer-tests.sql`` TEST 1-5; ``kmer.c:33-37``,
``:115-120``, ``:149-154``, ``:179-182``, ``:310-313``).
"""

from __future__ import annotations


class KmerEngineError(ValueError):
    """Base class for all engine errors (maps to the reference's ereport ERROR)."""

    message: str = "kmer engine error"
    detail: str | None = None

    def __init__(self, message: str | None = None, detail: str | None = None):
        if message is not None:
            self.message = message
        if detail is not None:
            self.detail = detail
        super().__init__(self.message)


class InvalidDnaSequenceError(KmerEngineError):
    """Raised on non-ACGT input to dna/kmer parsing (kmer.c:33-37)."""

    message = "Invalid DNA Sequence"
    detail = "Valid characters are A, C, G, T (case-insensitive)."


class KmerTooLongError(KmerEngineError):
    """Raised when a kmer literal exceeds 32 characters (kmer.c:115-120)."""

    message = "KMer Sequence larger than length 32"


class InvalidQkmerSequenceError(KmerEngineError):
    """Raised on a character outside the IUPAC alphabet (kmer.c:179-182)."""

    message = "Invalid QKMer Sequence"


class QkmerTooLongError(KmerEngineError):
    """Raised when a qkmer literal exceeds 32 characters (kmer.c:149-154)."""

    message = "QKMer Sequence larger than length 32"


class InvalidKmerLengthError(KmerEngineError):
    """Raised by generate_kmers for k <= 0, k > 32, or k > len(dna) (kmer.c:310-313)."""

    message = "Invalid KMER Length"
