"""Plain reference for a read sample: the exact (canonical key, count)
table of every window of every read, from the genome, the read starts,
the flips and the errors.

A window that no error touches is the genome window it was read from (a
reverse-complemented read reads the same canonical key), so the
error-free windows are the genome's windows weighted by the reads that
cover them, less the windows an error touches; those are counted from
the erroneous reads themselves.
"""

from __future__ import annotations

import numpy as np

from . import kmers

ROWS_AT_ONCE = 1 << 14  # erroneous reads keyed at a time (in cache)


def table(reads) -> tuple[np.ndarray, np.ndarray]:
    """(keys ascending, int64 counts) of ``reads`` (a ``gen.wgs_reads``
    sample)."""
    k, L = reads.k, reads.read_len
    m = L - k + 1
    if m <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    n_win = reads.genome.size - k + 1
    # reads covering genome window p: starts in [p - (L - k), p]
    cum = np.concatenate([[0], np.cumsum(np.bincount(reads.starts,
                                                     minlength=n_win))])
    p = np.arange(n_win)
    weight = cum[p + 1] - cum[np.maximum(p - (L - k), 0)]

    err_read = reads.err_at // L
    bad = np.unique(err_read)
    extra, read_back = [], []
    for s in range(0, bad.size, ROWS_AT_ONCE):
        rows = bad[s: s + ROWS_AT_ONCE]
        codes = _rows(reads, rows)
        # windows of these reads that an error touches
        a, b = np.searchsorted(err_read, [rows[0], rows[-1] + 1])
        where = np.searchsorted(rows, err_read[a:b])
        pos = reads.err_at[a:b] % L
        mark = np.zeros((rows.size, m + 1), np.int32)
        np.add.at(mark, (where, np.maximum(pos - k + 1, 0)), 1)
        np.add.at(mark, (where, np.minimum(pos, m - 1) + 1), -1)
        touched = np.cumsum(mark[:, :m], axis=1) > 0
        extra.append(kmers.canonical_keys(codes, k, reads.canonical)[touched])
        # and the genome windows they would have read
        r_idx, j = np.nonzero(touched)
        start = reads.starts[rows][r_idx]
        read_back.append(np.where(reads.flip[rows][r_idx],
                                  start + (m - 1 - j), start + j))
    if read_back:
        weight -= np.bincount(np.concatenate(read_back), minlength=n_win)
    g_keys = kmers.sequence_keys(reads.genome, k, reads.canonical)
    live = weight > 0
    keys = np.concatenate([g_keys[live], *extra])
    weights = np.concatenate([weight[live],
                              np.ones(keys.size - int(live.sum()), np.int64)])
    keys, counts = kmers.group(keys, weights)
    if int(counts.sum()) != reads.windows():
        raise AssertionError(
            f"reference counts {int(counts.sum())} windows, the sample has "
            f"{reads.windows()}")
    return keys, counts


def _rows(reads, rows: np.ndarray) -> np.ndarray:
    """The reads ``rows`` (sorted indices) as sequenced, in bulk."""
    L = reads.read_len
    view = np.lib.stride_tricks.sliding_window_view(reads.genome, L)
    codes = view[reads.starts[rows]]
    fl = reads.flip[rows]
    codes[fl] = 3 - codes[fl, ::-1]
    a, b = np.searchsorted(reads.err_at // L, [rows[0], rows[-1] + 1])
    at = reads.err_at[a:b]
    r = np.searchsorted(rows, at // L)
    codes[r, at % L] = (codes[r, at % L] + reads.err_shift[a:b]) % 4
    return codes
