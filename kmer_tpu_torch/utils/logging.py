"""Structured logging + pipeline counters (counterpart of
``kmer_tpu/utils/logging.py``)."""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
import time


def get_logger(name: str = "kmer_tpu_torch",
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


@dataclasses.dataclass
class StatsCounters:
    """Monotonic pipeline counters with derived rates."""

    reads: int = 0
    bases: int = 0
    kmers: int = 0
    unique_kmers: int = 0
    batches: int = 0
    grows: int = 0  # streaming fold: capacity growth events
    spills: int = 0  # streaming fold: sorted runs spilled
    breaks: int = 0  # n_policy "break": contigs begun at a non-ACGT run
    break_bases: int = 0  # n_policy "break": non-ACGT bytes broken at
    probe_cuts: int = 0  # file probes whose sample ended inside a record
    # sharded stream: live groups over slots sent by the partition merge
    merge_efficiency: float | None = None
    started_at: float = dataclasses.field(default_factory=time.time)

    def record_batch(self, n_reads: int, n_bases: int, n_kmers: int,
                     n_unique: int):
        self.reads += n_reads
        self.bases += n_bases
        self.kmers += n_kmers
        self.unique_kmers = n_unique  # running cardinality, not additive
        self.batches += 1

    @property
    def elapsed(self) -> float:
        return max(time.time() - self.started_at, 1e-9)

    def rates(self) -> dict[str, float]:
        return {
            "reads_per_s": self.reads / self.elapsed,
            "bases_per_s": self.bases / self.elapsed,
            "kmers_per_s": self.kmers / self.elapsed,
        }

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d.pop("started_at")
        d.update({k: round(v, 1) for k, v in self.rates().items()})
        d["elapsed_s"] = round(self.elapsed, 3)
        return json.dumps(d)
