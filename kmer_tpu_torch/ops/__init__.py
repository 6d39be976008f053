from .count import count_kmers  # noqa: F401
from .dense_count import (  # noqa: F401
    DENSE_MAX_K,
    check_dense_exact,
    count_kmers_dense,
)


def count_kmers_auto(reads_codes, lengths, k: int, canonical: bool = False):
    """Fixed-k counting with the route chosen by k: the dense histogram
    for k <= DENSE_MAX_K (guarded against the int32 counts lane's limit),
    the sort and the segment-count kernel otherwise."""
    if 0 < k <= DENSE_MAX_K:
        return check_dense_exact(
            count_kmers_dense(reads_codes, lengths, k, canonical))
    return count_kmers(reads_codes, lengths, k, canonical)
