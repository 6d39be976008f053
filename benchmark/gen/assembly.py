"""One chromosome of an assembly as a single FASTA record, made from
``--seed``.

The bases are uniform, with seeded copies of a few repeat elements at a
fixed divergence laid over them, one copy in each equal stretch at a
seeded offset.  The N runs have fixed sizes: a telomere run at each end,
and between the seeded ACGT segments, small gaps and one centromere run
in the middle.  Every seed gives the same number of ACGT bases, N bases
and repeat copies, so the same windows.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .wgs_reads import pack_words

N_CODE = 4
LETTERS = np.frombuffer(b"ACGTN", np.uint8)


@dataclasses.dataclass(frozen=True)
class Assembly:
    """The chromosome: the inputs the program is fed and the reference
    reads."""

    codes: np.ndarray  # uint8, 0..3 for ACGT and 4 for N
    k: int
    canonical: bool
    n_policy: str  # "skip": N bases are dropped and the flanks joined

    def windows(self) -> int:
        """Valid k-mer windows: what one job counts."""
        if self.n_policy == "skip":
            return max(int((self.codes < N_CODE).sum()) - self.k + 1, 0)
        raise ValueError(f"unknown n_policy {self.n_policy!r}")


def _segments(total: int, parts: int, rng) -> np.ndarray:
    """``parts`` seeded lengths, each within half of the mean, that sum
    to ``total`` exactly."""
    w = 1.0 + rng.uniform(-0.5, 0.5, parts)
    lens = np.floor(total * w / w.sum()).astype(np.int64)
    lens[-1] += total - lens.sum()
    return lens


def sample(cfg: dict, seed: int) -> Assembly:
    """The chromosome of configuration ``cfg`` for ``seed``."""
    rng = np.random.default_rng(seed)
    gaps = cfg["n_runs"]
    n_small, small = gaps["small_gaps"], gaps["small_gap_bases"]
    n_bases = (2 * gaps["telomere_bases"] + n_small * small
               + gaps["centromere_bases"])
    acgt_bases = cfg["total_bases"] - n_bases
    seq = rng.integers(0, 4, acgt_bases, dtype=np.uint8)

    rep = cfg["repeats"]
    e_len = rep["element_bases"]
    copies = int(rep["share"] * acgt_bases) // e_len
    if copies:
        consensus = rng.integers(0, 4, (rep["families"], e_len),
                                 dtype=np.uint8)
        body = consensus[rng.integers(0, rep["families"], copies)]
        mutate = rng.random((copies, e_len)) < rep["divergence"]
        shift = rng.integers(1, 4, (copies, e_len), dtype=np.uint8)
        body = np.where(mutate, (body + shift) % 4, body).astype(np.uint8)
        stretch = acgt_bases // copies
        at = (np.arange(copies) * stretch
              + rng.integers(0, stretch - e_len + 1, copies))
        seq[at[:, None] + np.arange(e_len)] = body

    # segments between the N runs: telomere, small gaps with the
    # centromere in the middle, telomere
    inner = [small] * n_small
    inner.insert(n_small // 2, gaps["centromere_bases"])
    seg = _segments(acgt_bases, len(inner) + 1, rng)
    runs = [gaps["telomere_bases"], *inner, gaps["telomere_bases"]]
    codes = np.empty(cfg["total_bases"], np.uint8)
    at, src = 0, 0
    for i, n_run in enumerate(runs):
        codes[at: at + n_run] = N_CODE
        at += n_run
        if i < seg.size:
            codes[at: at + seg[i]] = seq[src: src + seg[i]]
            at += seg[i]
            src += seg[i]
    return Assembly(codes=codes, k=cfg["k"], canonical=cfg["canonical"],
                    n_policy=cfg["n_policy"])


def write(asm: Assembly, cfg: dict, fmt: str, path: str) -> int:
    """Writes the chromosome as one FASTA record of ``line_bases``-base
    lines; returns the bytes written."""
    if fmt != "fasta":
        raise ValueError(f"an assembly is written as fasta, not {fmt}")
    width = cfg["line_bases"]
    letters = LETTERS[asm.codes]
    full = letters.size // width
    body = np.empty((full, width + 1), np.uint8)
    body[:, :width] = letters[: full * width].reshape(full, width)
    body[:, width] = ord("\n")
    tail = letters[full * width:]
    size = 0
    with open(path, "wb") as f:
        size += f.write(b">" + cfg["header"].encode() + b"\n")
        size += f.write(body.tobytes())
        if tail.size:
            size += f.write(tail.tobytes() + b"\n")
    return size



def wire_batches(asm: Assembly, width: int, batch: int
                 ) -> list[tuple[np.ndarray, np.ndarray]]:
    """The chromosome in the port's packed wire layout, cut as a long
    record is cut into rows: its ACGT bases (N bases skipped, the
    configuration's policy) in rows of ``width`` bases that overlap by
    k - 1, so that every window lies in one row once; fixed-shape batches
    of (words [batch, width / 16] uint32, lengths [batch] uint16), the
    last batch padded with rows of length 0."""
    if asm.n_policy != "skip":
        raise ValueError(f"unknown n_policy {asm.n_policy!r}")
    if width % 16 or width < asm.k:
        raise ValueError(f"rows of {width} bases: a multiple of 16 and at "
                         f"least k = {asm.k}")
    seq = asm.codes[asm.codes < N_CODE]
    step = width - asm.k + 1
    n_rows = max(1, -(-max(seq.size - asm.k + 1, 0) // step))
    padded = np.zeros((n_rows - 1) * step + width, np.uint8)
    padded[: seq.size] = seq
    rows = np.lib.stride_tricks.sliding_window_view(padded, width)[::step]
    n_batches = -(-n_rows // batch)
    words = np.zeros((n_batches * batch, width // 16), np.uint32)
    lens = np.zeros(n_batches * batch, np.uint16)
    lens[:n_rows] = np.minimum(width, seq.size - np.arange(n_rows) * step)
    for s in range(0, n_rows, 1 << 14):
        e = min(n_rows, s + (1 << 14))
        words[s:e] = pack_words(rows[s:e])
    return [(words[b * batch:(b + 1) * batch], lens[b * batch:(b + 1) * batch])
            for b in range(n_batches)]
