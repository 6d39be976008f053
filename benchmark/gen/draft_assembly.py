"""A scaffolded draft assembly as a multi-record FASTA, made from
``--seed``: chromosome-scale scaffolds whose contigs are joined by fixed
gaps of N, then unplaced scaffolds of one contig each.

Each chromosome-scale scaffold is laid out as ``gen.assembly`` lays out a
chromosome (uniform bases with seeded copies of repeat elements, a
telomere run at each end, small gaps between seeded ACGT segments, one
centromere run in the middle), from its own seeded stream.  The unplaced
scaffolds cut one more such sequence, with no N, at seeded lengths that
sum exactly.  Every seed gives the same number of contigs, ACGT bases and
N bases, so the same windows, counted contig by contig: the
configuration's ``n_policy`` is "break".
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import assembly
from .assembly import LETTERS, N_CODE, _segments


@dataclasses.dataclass(frozen=True)
class Draft:
    """The draft: the inputs the program is fed and the reference reads."""

    codes: np.ndarray  # uint8, every scaffold end to end; 4 for N
    ends: np.ndarray  # int64: where each scaffold ends in ``codes``
    k: int
    canonical: bool
    n_policy: str  # "break": a run of N ends the contig

    def scaffolds(self):
        """Each scaffold's codes, a view of ``codes``."""
        start = 0
        for end in self.ends:
            yield self.codes[start:end]
            start = int(end)

    def contig_lengths(self) -> np.ndarray:
        """The length of every maximal ACGT run of every scaffold."""
        base = np.concatenate([[False], self.codes < N_CODE, [False]])
        edges = np.flatnonzero(base[1:] != base[:-1])
        starts, ends = edges[0::2], edges[1::2]
        # a run that goes on past a scaffold's end is two contigs
        cut = self.ends[:-1]
        cut = cut[base[cut] & base[cut + 1]]
        starts = np.sort(np.concatenate([starts, cut]))
        ends = np.sort(np.concatenate([ends, cut]))
        return ends - starts

    def windows(self) -> int:
        """Valid k-mer windows: what one job counts."""
        if self.n_policy != "break":
            raise ValueError(f"unknown n_policy {self.n_policy!r}")
        return int(np.maximum(self.contig_lengths() - self.k + 1, 0).sum())


def _chromosome(cfg: dict, scaffold: dict, seed) -> np.ndarray:
    """One scaffold's codes as ``gen.assembly`` lays out a chromosome."""
    sub = {**scaffold, "repeats": cfg["repeats"], "k": cfg["k"],
           "canonical": cfg["canonical"], "n_policy": cfg["n_policy"]}
    return assembly.sample(sub, seed).codes


def sample(cfg: dict, seed: int) -> Draft:
    """The draft of configuration ``cfg`` for ``seed``."""
    parts = [_chromosome(cfg, sc, [seed, i])
             for i, sc in enumerate(cfg["scaffolds"])]
    un = cfg["unplaced"]
    n_sc = len(parts)
    no_gaps = {"telomere_bases": 0, "centromere_bases": 0, "small_gaps": 0,
               "small_gap_bases": 0}
    bases = _chromosome(cfg, {"total_bases": un["total_bases"],
                              "n_runs": no_gaps}, [seed, n_sc])
    lens = _segments(un["total_bases"], un["scaffolds"],
                     np.random.default_rng([seed, n_sc + 1]))
    sizes = [p.size for p in parts] + lens.tolist()
    return Draft(codes=np.concatenate(parts + [bases]),
                 ends=np.cumsum(sizes, dtype=np.int64), k=cfg["k"],
                 canonical=cfg["canonical"], n_policy=cfg["n_policy"])


def _record(letters: np.ndarray, header: bytes, width: int) -> bytes:
    """One FASTA record of ``width``-base lines."""
    full = letters.size // width
    body = np.empty((full, width + 1), np.uint8)
    body[:, :width] = letters[: full * width].reshape(full, width)
    body[:, width] = ord("\n")
    tail = letters[full * width:]
    return (b">" + header + b"\n" + body.tobytes()
            + (tail.tobytes() + b"\n" if tail.size else b""))


def write(draft: Draft, cfg: dict, fmt: str, path: str) -> int:
    """Writes the draft as FASTA, a record ``>scaffold_<n>`` (from 1) of
    ``line_bases``-base lines a scaffold; returns the bytes written."""
    if fmt != "fasta":
        raise ValueError(f"an assembly is written as fasta, not {fmt}")
    size = 0
    with open(path, "wb") as f:
        for i, codes in enumerate(draft.scaffolds()):
            header = f"{cfg['header']}{i + 1}".encode()
            size += f.write(_record(LETTERS[codes], header,
                                    cfg["line_bases"]))
    return size
