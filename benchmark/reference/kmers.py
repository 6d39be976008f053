"""Plain k-mer arithmetic for the references, in NumPy and PyTorch on the
CPU.

A key here is what the program writes: the k bases of a window at 2 bits
each (A 0, C 1, G 2, T 3), the first base in the top bits of a 64-bit
word, the low 64 - 2k bits zero.  Canonical is the smaller, unsigned, of
a window's key and its reverse complement's.  Nothing here imports the
program.  k is at most 31.
"""

from __future__ import annotations

import numpy as np
import torch


def window_values(rows: np.ndarray, k: int) -> np.ndarray:
    """[n, L] codes 0..3 -> uint64 [n, L - k + 1]: window i's k bases as
    a 2k-bit number, the first base most significant (by doubling:
    windows of 1, 2, 4, ... bases, then the binary parts of k).  Plain
    PyTorch on the CPU, whose elementwise ops use every core; a value of
    at most 62 bits fits an int64."""
    if not 1 <= k <= 31:
        raise ValueError(f"k {k} outside 1..31")
    rows = torch.from_numpy(np.ascontiguousarray(rows, np.uint8))
    n, L = rows.shape
    m = L - k + 1
    if m <= 0:
        return np.zeros((n, 0), np.uint64)
    parts = {1: rows.to(torch.int64)}
    span = 1
    while span * 2 <= k:
        cur = parts[span]
        parts[span * 2] = (cur[:, :-span] << (2 * span)) | cur[:, span:]
        span *= 2
    key = torch.zeros((n, m), dtype=torch.int64)
    off = 0
    for p in sorted(parts, reverse=True):
        if k & p:
            key = (key << (2 * p)) | parts[p][:, off: off + m]
            off += p
    return key.numpy().view(np.uint64)


def canonical_keys(rows: np.ndarray, k: int, canonical: bool = True
                   ) -> np.ndarray:
    """[n, L] codes -> uint64 [n, L - k + 1] left-aligned keys of every
    window, canonical when asked."""
    fwd = window_values(rows, k)
    if canonical:
        rc = window_values(3 - np.asarray(rows)[:, ::-1], k)[:, ::-1]
        fwd = np.minimum(fwd, rc)
    return fwd << np.uint64(64 - 2 * k)


def sequence_keys(seq: np.ndarray, k: int, canonical: bool = True,
                  block: int = 1 << 18) -> np.ndarray:
    """uint64 left-aligned keys of every window of one sequence of codes,
    keyed ``block`` windows at a time (temporaries that stay in cache are
    several times faster than whole-sequence ones)."""
    n_win = max(seq.size - k + 1, 0)
    keys = np.empty(n_win, np.uint64)
    for s in range(0, n_win, block):
        e = min(n_win, s + block)
        keys[s:e] = canonical_keys(seq[None, s: e + k - 1], k, canonical)[0]
    return keys


def group(keys: np.ndarray, weights: np.ndarray | None = None
          ) -> tuple[np.ndarray, np.ndarray]:
    """(distinct keys ascending, int64 total weight of each)."""
    keys = np.asarray(keys, np.uint64).reshape(-1)
    if weights is None:
        uniq, counts = np.unique(keys, return_counts=True)
        return uniq, counts.astype(np.int64)
    order = np.argsort(keys)
    keys = keys[order]
    weights = np.asarray(weights, np.int64).reshape(-1)[order]
    if keys.size == 0:
        return keys, weights
    head = np.ones(keys.size, bool)
    head[1:] = keys[1:] != keys[:-1]
    first = np.flatnonzero(head)
    return keys[first], np.add.reduceat(weights, first)


def truncate(keys: np.ndarray, counts: np.ndarray, key_bits: int
             ) -> tuple[np.ndarray, np.ndarray]:
    """The table regrouped with each key cut to its top ``key_bits`` bits:
    the control's lower precision.  64 bits leave it as it is."""
    if key_bits >= 64:
        return keys, counts
    mask = np.uint64(((1 << key_bits) - 1) << (64 - key_bits))
    return group(keys & mask, counts)
