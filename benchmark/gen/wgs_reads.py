"""Whole-genome sequencing reads of one sample, made from ``--seed``.

The sampling is a frozen copy of the repository's ``chip_smoke.py``
``write_genome_run``: a uniform random genome, uniform read starts, half
the reads reverse-complemented.  On top of it, a fixed number of uniform
substitution errors (``substitution_rate`` of all read bases, at
distinct positions drawn from the seed), each replacing its base by one of
the other three.  Every seed gives the same number of reads, bases,
windows and errors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LETTERS = np.frombuffer(b"ACGT", np.uint8)
CHUNK_READS = 250_000  # reads built and written at a time
# the port's wire: base j of a row at bits 30 - 2 * (j % 16) of word j // 16
_SHIFTS = (30 - 2 * np.arange(16, dtype=np.uint32)).astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class Reads:
    """The sample: the inputs the program is fed and the reference reads."""

    genome: np.ndarray  # uint8 codes 0..3
    starts: np.ndarray  # int64, one per read
    flip: np.ndarray  # bool, the read is the reverse complement
    err_at: np.ndarray  # int64 flat positions (read * read_len + base), sorted
    err_shift: np.ndarray  # uint8 1..3: the new base is (old + shift) % 4
    read_len: int
    k: int
    canonical: bool

    @property
    def n_reads(self) -> int:
        return int(self.starts.size)

    def windows(self) -> int:
        """Valid k-mer windows in the sample: what one job counts."""
        return self.n_reads * max(self.read_len - self.k + 1, 0)

    def read_codes(self, lo: int, hi: int) -> np.ndarray:
        """Reads lo..hi as sequenced: [hi - lo, read_len] codes 0..3."""
        L = self.read_len
        view = np.lib.stride_tricks.sliding_window_view(self.genome, L)
        reads = view[self.starts[lo:hi]]  # a copy
        fl = self.flip[lo:hi]
        reads[fl] = 3 - reads[fl, ::-1]
        a, b = np.searchsorted(self.err_at, [lo * L, hi * L])
        at = self.err_at[a:b] - lo * L
        flat = reads.reshape(-1)
        flat[at] = (flat[at] + self.err_shift[a:b]) % 4
        return reads


def sample(cfg: dict, seed: int) -> Reads:
    """The sample of configuration ``cfg`` for ``seed``."""
    G, L, n = cfg["genome_bases"], cfg["read_len"], cfg["n_reads"]
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    starts = rng.integers(0, G - L + 1, n)
    flip = rng.random(n) < cfg.get("reverse_complement_share", 0.5)
    n_err = int(round(cfg["substitution_rate"] * n * L))
    err_at = np.sort(rng.choice(n * L, n_err, replace=False, shuffle=False))
    err_shift = rng.integers(1, 4, n_err, dtype=np.uint8)
    return Reads(genome=genome, starts=starts, flip=flip, err_at=err_at,
                 err_shift=err_shift, read_len=L, k=cfg["k"],
                 canonical=cfg["canonical"])


def fastq_records(reads: np.ndarray, first: int, digits: int,
                  quality: int) -> bytes:
    """FASTQ records of fixed-length code reads [n, L], named ``r`` and
    ``digits`` decimal digits from ``first`` on (``chip_smoke.py``'s
    ``fastq_records`` with the width of the name and the quality as
    parameters)."""
    n, length = reads.shape
    head = 2 + digits
    rec = np.empty((n, head + 1 + length + 3 + length + 1), np.uint8)
    rec[:, 0], rec[:, 1] = ord("@"), ord("r")
    idx = np.arange(first, first + n)
    for d in range(digits):
        rec[:, 2 + d] = ord("0") + (idx // 10 ** (digits - 1 - d)) % 10
    rec[:, head] = ord("\n")
    rec[:, head + 1: head + 1 + length] = LETTERS[reads]
    q = head + 1 + length
    rec[:, q: q + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, q + 3: q + 3 + length] = quality
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def write(reads: Reads, cfg: dict, fmt: str, path: str) -> int:
    """Writes the sample as a FASTQ file; returns the bytes written."""
    if fmt != "fastq":
        raise ValueError(f"a read sample is written as fastq, not {fmt}")
    digits = max(7, len(str(max(reads.n_reads - 1, 0))))
    quality = ord(cfg.get("quality_char", "I"))
    size = 0
    with open(path, "wb") as f:
        for s in range(0, reads.n_reads, CHUNK_READS):
            e = min(reads.n_reads, s + CHUNK_READS)
            size += f.write(fastq_records(reads.read_codes(s, e), s, digits,
                                          quality))
    return size


def pack_words(rows: np.ndarray) -> np.ndarray:
    """[n, width] codes 0..3 (width a multiple of 16) -> [n, width / 16]
    uint32 words, the tail of a row zero."""
    n, width = rows.shape
    grouped = rows.astype(np.uint32).reshape(n, width // 16, 16)
    return (grouped << _SHIFTS).sum(axis=2, dtype=np.uint32)


def wire_batches(reads: Reads, width: int, batch: int
                 ) -> list[tuple[np.ndarray, np.ndarray]]:
    """The sample in the port's packed wire layout: fixed-shape batches of
    (words [batch, width / 16] uint32, lengths [batch] uint16), every read
    one row, the last batch padded with rows of length 0."""
    L = reads.read_len
    if L > width or width % 16:
        raise ValueError(f"reads of {L} bases need one row of a width "
                         f"that is a multiple of 16, not {width}")
    n = reads.n_reads
    n_batches = max(1, -(-n // batch))
    words = np.zeros((n_batches * batch, width // 16), np.uint32)
    lens = np.zeros(n_batches * batch, np.uint16)
    lens[:n] = L
    for s in range(0, n, CHUNK_READS):
        e = min(n, s + CHUNK_READS)
        rows = np.zeros((e - s, width), np.uint8)
        rows[:, :L] = reads.read_codes(s, e)
        words[s:e] = pack_words(rows)
    return [(words[b * batch:(b + 1) * batch], lens[b * batch:(b + 1) * batch])
            for b in range(n_batches)]


def code_batches(reads: Reads, batch: int
                 ) -> list[tuple[np.ndarray, np.ndarray]]:
    """The sample as 2-bit codes: fixed-shape batches of (codes [batch,
    read_len] uint8 0..3, lengths [batch] int32), every read one row, the
    last batch padded with rows of length 0."""
    L, n = reads.read_len, reads.n_reads
    n_batches = max(1, -(-n // batch))
    codes = np.zeros((n_batches * batch, L), np.uint8)
    lens = np.zeros(n_batches * batch, np.int32)
    lens[:n] = L
    for s in range(0, n, CHUNK_READS):
        e = min(n, s + CHUNK_READS)
        codes[s:e] = reads.read_codes(s, e)
    return [(codes[b * batch:(b + 1) * batch], lens[b * batch:(b + 1) * batch])
            for b in range(n_batches)]
