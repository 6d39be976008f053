"""Plain reference for a scaffolded draft: the exact (canonical key, count)
table of every window of every contig, where a contig is a maximal run of
ACGT codes inside one scaffold.

``n_policy`` "break" splits each scaffold's codes at every N and keys each
contig alone, as meryl, jellyfish and KMC count an assembly.
"""

from __future__ import annotations

import numpy as np

from . import kmers


def contigs(scaffold: np.ndarray):
    """The maximal ACGT runs (codes below 4) of one scaffold's codes."""
    gap = np.concatenate([[1], (scaffold >= 4).view(np.int8), [1]])
    step = np.diff(gap)
    for a, b in zip(np.flatnonzero(step == -1), np.flatnonzero(step == 1)):
        yield scaffold[a:b]


def table(draft) -> tuple[np.ndarray, np.ndarray]:
    """(keys ascending, int64 counts) of ``draft`` (a
    ``gen.draft_assembly`` draft)."""
    if draft.n_policy != "break":
        raise ValueError(f"unknown n_policy {draft.n_policy!r}")
    k = draft.k
    pieces = [c for s in draft.scaffolds() for c in contigs(s)
              if c.size >= k]
    keys = np.empty(sum(c.size - k + 1 for c in pieces), np.uint64)
    at = 0
    for c in pieces:
        keys[at: at + c.size - k + 1] = kmers.sequence_keys(c, k,
                                                            draft.canonical)
        at += c.size - k + 1
    return kmers.group(keys)
