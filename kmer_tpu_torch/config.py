"""Typed engine configuration (counterpart of ``kmer_tpu/config.py``).

One dataclass consumed by ``KmerCounter``, the graft entry and the CLI's
bench, with ``kmer_tpu``'s fields, defaults and validation.
"""

from __future__ import annotations

import dataclasses

from .codec import MAX_K
from .errors import InvalidKmerLengthError


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-wide settings.

    k:            window size for extraction/counting (1..32).
    canonical:    count min(kmer, revcomp) instead of forward kmers
                  (off for reference parity; on for the north-star metric).
    chunk_reads:  reads per device batch for streaming counts.
    read_len:     padded read length for batched pipelines.
    mesh_shape:   (data, seq) device mesh extents; None = single device.
    use_pallas:   ``kmer_tpu``'s switch between its Pallas segment counts
                  and its XLA ones.  The port has one route: on a CUDA
                  tensor the count launches the segment-count kernel, so
                  only True activates.
    """

    k: int = 21
    canonical: bool = False
    chunk_reads: int = 1 << 17
    read_len: int = 150
    mesh_shape: tuple[int, int] | None = None
    use_pallas: bool = True

    def __post_init__(self):
        if not (0 < self.k <= MAX_K):
            raise InvalidKmerLengthError()

    def activate(self) -> "EngineConfig":
        """Apply runtime-effective settings (idempotent); raises for
        ``use_pallas=False``, which the port does not offer."""
        if not self.use_pallas:
            raise NotImplementedError(
                "use_pallas=False (bench --no-pallas) is not ported: on a "
                "CUDA device the count always launches the segment-count "
                "kernel, and the port never swaps a kernel for its plain "
                "version on the card (ROADMAP.md §1 item 2, config)")
        return self

    def windows_per_read(self) -> int:
        return self.read_len - self.k + 1
