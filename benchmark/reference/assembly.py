"""Plain reference for an assembly: the exact (canonical key, count) table
of every window of the chromosome's codes.

``n_policy`` "skip" drops the N bases and joins their flanks, as the
configuration states for its input.
"""

from __future__ import annotations

import numpy as np

from . import kmers


def table(asm) -> tuple[np.ndarray, np.ndarray]:
    """(keys ascending, int64 counts) of ``asm`` (a ``gen.assembly``
    chromosome)."""
    if asm.n_policy != "skip":
        raise ValueError(f"unknown n_policy {asm.n_policy!r}")
    return kmers.group(kmers.sequence_keys(asm.codes[asm.codes < 4], asm.k,
                                           asm.canonical))
