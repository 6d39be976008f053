"""Dense histogram counting for small k (4^k bins fit in memory).

The counterpart of ``kmer_tpu/ops/dense_count.py``.  For k <=
``DENSE_MAX_K`` the whole key space is small enough to count into a dense
[4^k] table, which replaces the sort.  ``kmer_tpu`` builds that histogram
as one-hot matmuls on the MXU with f32 accumulation; here it is one int64
``index_add_`` of the right-aligned valid keys into the [4^k] bins.

The table keeps ``kmer_tpu``'s dense layout, so its raw arrays compare
slot for slot: all 4^k bins in ascending bin order, each key the bin
left-aligned to bit 63, length k, int32 counts (0 for an absent k-mer).

The one behavioural difference: f32 accumulation saturates at 2^24, so
``kmer_tpu``'s ``check_dense_exact`` rejects a bin that reaches 2^24.  An
int64 count has no such limit; the only limit left is the int32 counts
lane, where ``dense_to_table`` clamps at 2^31 - 1, so a bin that reaches
``DENSE_EXACT_LIMIT`` = 2^31 - 1 is rejected.  Between the two limits the
port returns the exact count that the sort path gives.

``DENSE_ROUTE_K`` is ``KmerCounter``'s routing threshold (dense at and
below it), kept at ``kmer_tpu``'s value until the port's own timings
(``chip_smoke.py`` phase 10 prints both routes at k = 4, 6, 8, 10) say
otherwise.
"""

from __future__ import annotations

import torch

from ..kernels.codes_keys import as_codes, codes_keys
from .count import CountTable

DENSE_MAX_K = 10
DENSE_ROUTE_K = 6  # KmerCounter takes the dense route at and below this k

# the int32 counts lane clamps here, so a bin that reads this value may
# have been cut and is rejected
DENSE_EXACT_LIMIT = (1 << 31) - 1

# bins the histogram's copies span in all (dense_histogram)
SPREAD_SLOTS = 1 << 16


def check_bin_max(max_count: int) -> None:
    """Raise if the largest bin count reached the int32 counts lane's
    limit."""
    if max_count >= DENSE_EXACT_LIMIT:
        raise ValueError(
            "dense histogram bin reached 2^31 - 1: the int32 counts lane "
            "clamps there — recount via the sort path (count_kmers) into "
            "the 64-bit accumulator (ops/wide)"
        )


def check_dense_exact(table: CountTable) -> CountTable:
    """Raise if a bin reached the int32 counts lane's limit (one host read)."""
    if table.capacity:
        check_bin_max(int(table.counts.max()))
    return table


def right_aligned_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Left-aligned int64 keys -> right-aligned 2k-bit bins (k <= 16).

    ``>>`` on int64 is arithmetic, so the bins are masked after the shift:
    a key whose first base is ``g`` or ``t`` has bit 63 set.
    """
    if not 1 <= k <= 16:
        raise ValueError(f"right_aligned_keys needs 1 <= k <= 16, got {k}")
    return (keys >> (64 - 2 * k)) & ((1 << (2 * k)) - 1)


def dense_histogram(values: torch.Tensor, valid: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Exact int64 [4^k] histogram of right-aligned 2k-bit values.

    Invalid slots go to one extra bin past the table, which is dropped,
    so no boolean select is needed.  The bins are summed with
    ``index_add_`` into a table of known size: ``torch.bincount`` reads
    its input's min and max back to the host on CUDA, a sync every call.
    For small k the adds of a few hundred bins would queue on the same
    addresses, so each position along the last axis adds into one of
    ``copies`` tables, about ``SPREAD_SLOTS`` bins in all, summed after.
    """
    nbins = 1 << (2 * k)
    width = nbins + 1
    copies = max(1, SPREAD_SLOTS // width)
    slots = torch.where(valid, values, nbins)
    if copies > 1:
        pos = torch.arange(values.shape[-1], device=values.device)
        slots += (pos % copies) * width
    slots = slots.reshape(-1)
    hist = torch.zeros(copies * width, dtype=torch.int64, device=values.device)
    hist.index_add_(0, slots, torch.ones_like(slots))
    return hist.view(copies, width)[:, :nbins].sum(0)


def dense_to_table(dense: torch.Tensor, k: int) -> CountTable:
    """Dense [4^k] counts -> CountTable (keys = left-aligned bin ids)."""
    nbins = dense.shape[0]
    counts = dense.clamp(max=DENSE_EXACT_LIMIT).to(torch.int32)
    bins = torch.arange(nbins, dtype=torch.int64, device=dense.device)
    # bins of a leading g or t wrap past bit 63: the int64 shift keeps the
    # bits, which is the key
    keys = bins << (64 - 2 * k)
    return CountTable(keys=keys, length=torch.full_like(counts, k),
                      counts=counts,
                      n_unique=(counts > 0).sum().to(torch.int32))


def count_kmers_dense(reads_codes: torch.Tensor, lengths: torch.Tensor,
                      k: int, canonical: bool = False) -> CountTable:
    """Fixed-k counting through the dense histogram (k <= DENSE_MAX_K)."""
    if not (0 < k <= DENSE_MAX_K):
        raise ValueError(f"dense path requires k <= {DENSE_MAX_K}")
    keys, valid = codes_keys(as_codes(reads_codes), lengths, k, canonical)
    dense = dense_histogram(right_aligned_keys(keys, k), valid, k)
    return dense_to_table(dense, k)
