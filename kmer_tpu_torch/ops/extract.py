"""Sliding-window k-mer extraction and canonicalization on int64 keys.

The counterpart of ``kmer_tpu/ops/extract.py``.  A key is the 64-bit
left-aligned packing of ``packed.py`` held in one int64; every function
here is plain PyTorch on the device of its input.

``generate_kmers`` is the parity form of the reference's SRF
(kmer.c:287-351) on the host: windows in order, duplicates kept, and
"Invalid KMER Length" for k <= 0, k > 32 or k > len(dna).

Two int64 traps shape the code: ``>>`` is arithmetic, so every right
shift of a key is masked after it, and key order is unsigned, so
comparisons run on ``key ^ SIGN_FLIP``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec import MAX_K
from ..errors import InvalidKmerLengthError
from ..packed import SIGN_FLIP
from ..types import Dna, Kmer


def generate_kmers(dna, k: int) -> list[Kmer]:
    """The k-windows of a dna value as Kmers, in order, duplicates kept;
    len(dna) < k, k <= 0 or k > 32 raise "Invalid KMER Length"."""
    d = Dna(dna)
    k = int(k)
    if len(d) < k or k <= 0 or k > MAX_K:
        raise InvalidKmerLengthError()
    codes = d.codes
    return [Kmer.from_codes(codes[i: i + k]) for i in range(len(d) - k + 1)]


def extract_to_strings(dna, k: int) -> list[str]:
    """generate_kmers as lowercase strings."""
    return [str(km) for km in generate_kmers(dna, k)]


def _top_mask(k: int) -> int:
    """The int64 mask of a key's top 2k bits (all ones for k = 32)."""
    return -(1 << (64 - 2 * k))


def extract_windows(codes: torch.Tensor, k: int) -> torch.Tensor:
    """codes [n] 2-bit codes -> int64 keys [n-k+1] of every window.

    Window i packs codes[i:i+k] left-aligned (base j at bits 62-2j).
    """
    n = codes.shape[0]
    m = n - k + 1
    if not 1 <= k <= MAX_K or m <= 0:
        raise InvalidKmerLengthError()
    codes = codes.to(torch.int64)
    keys = torch.zeros(m, dtype=torch.int64, device=codes.device)
    for j in range(k):
        keys |= codes[j: j + m] << (62 - 2 * j)
    return keys


def extract_windows_batch(codes: torch.Tensor, lengths: torch.Tensor,
                          k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched extraction over padded reads.

    codes: [B, L] 2-bit codes (padded); lengths: [B].  Returns (keys int64
    [B, L-k+1], valid bool [B, L-k+1]); window (b, i) is valid iff
    ``i <= lengths[b] - k``.
    """
    b, n = codes.shape
    m = n - k + 1
    if not 1 <= k <= MAX_K or m <= 0:
        raise InvalidKmerLengthError()
    codes = codes.to(torch.int64)
    keys = torch.zeros((b, m), dtype=torch.int64, device=codes.device)
    for j in range(k):
        keys |= codes[:, j: j + m] << (62 - 2 * j)
    pos = torch.arange(m, device=codes.device)
    valid = pos[None, :] <= (lengths.to(torch.int64)[:, None] - k)
    return keys, valid


# (mask, shift) steps that reverse the 32 2-bit groups of a 64-bit word;
# each mask has its top `shift` bits clear, so it also strips the sign
# bits an arithmetic right shift drags in
_REVERSE_STEPS = (
    (0x3333333333333333, 2),
    (0x0F0F0F0F0F0F0F0F, 4),
    (0x00FF00FF00FF00FF, 8),
    (0x0000FFFF0000FFFF, 16),
    (0x00000000FFFFFFFF, 32),
)


def revcomp_packed(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of left-aligned int64 k-mer keys of length k.

    The complement of a 2-bit code c is 3-c == ~c; reversing the 32 groups
    of the 64-bit key right-aligns the reverse complement, and a left
    shift by ``64 - 2k`` re-left-aligns it while dropping the complemented
    padding.  For k = 32 that shift is 0 and is skipped: a shift by 64 is
    not 0 on every device.
    """
    x = ~keys
    for mask, s in _REVERSE_STEPS:
        x = ((x >> s) & mask) | ((x & mask) << s)
    s = 64 - 2 * k
    return x if s == 0 else x << s


def canonicalize(keys: torch.Tensor, k: int) -> torch.Tensor:
    """min(key, revcomp(key)) in unsigned key order, elementwise."""
    rc = revcomp_packed(keys, k)
    return torch.where((keys ^ SIGN_FLIP) <= (rc ^ SIGN_FLIP), keys, rc)


# Phase-major extraction straight from the 2-bit wire words (16 bases a
# word, left-aligned), without unpacking to codes.  The window at flat
# base position p = 16w + r spans words w..w+2: it is the 64 bits that
# start 2r bits into word w, so for a fixed phase r every window is the
# same shift of (word w, w+1, w+2), and the keys come out as [16, nw].


def extract_from_words(words: torch.Tensor, k: int) -> torch.Tensor:
    """words [nw] (uint32 values, as int32 bits, int64 or uint32) -> int64
    keys [16, nw]: the window at p = 16w + r is ``keys[r, w]``.  Windows
    whose tail runs past the stream's end read zeros (callers mask
    validity)."""
    if not 1 <= k <= MAX_K:
        raise InvalidKmerLengthError()
    w0 = words.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    nw = w0.numel()
    pad = w0.new_zeros(2)
    w1 = torch.cat([w0[1:], pad])[:nw]
    w2 = torch.cat([w0[2:], pad])[:nw]
    w01 = (w0 << 32) | w1  # the 64 bits that start at word w
    mask = _top_mask(k)
    keys = torch.empty((16, nw), dtype=torch.int64, device=w0.device)
    keys[0] = w01 & mask
    for r in range(1, 16):
        # w2 is non-negative, so its arithmetic shift needs no mask
        keys[r] = ((w01 << 2 * r) | (w2 >> (32 - 2 * r))) & mask
    return keys


def phase_major_valid(n_words: int, read_len: int, n_reads: int, k: int,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """Validity [16, n_words] of phase-major windows over reads of
    ``read_len`` bases concatenated back to back: p = 16w + r is a valid
    window start iff ``p % read_len <= read_len - k`` and
    ``p <= n_reads * read_len - k``."""
    w = torch.arange(n_words, dtype=torch.int64, device=device)[None, :]
    r = torch.arange(16, dtype=torch.int64, device=device)[:, None]
    p = 16 * w + r
    return ((p % read_len) <= (read_len - k)) & (p <= n_reads * read_len - k)


def simulate_reads(num_reads: int, read_len: int, seed: int = 0) -> np.ndarray:
    """Random 2-bit code reads [num_reads, read_len] (benchmark inputs)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=(num_reads, read_len), dtype=np.uint8)


def simulate_coverage_reads(
    num_reads: int, read_len: int, genome_bases: int, seed: int = 0
) -> np.ndarray:
    """Reads sampled from one random genome, half of them reverse
    complemented: each genomic k-mer repeats ~num_reads*read_len/genome
    times, so the sorted keys have long equal-key segments."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_bases, dtype=np.uint8)
    starts = rng.integers(0, genome_bases - read_len + 1, size=num_reads)
    idx = starts[:, None] + np.arange(read_len)[None, :]
    reads = genome[idx]
    flip = rng.random(num_reads) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    return reads
