"""Synthetic test-data generator (the port's copy of
``kmer_tpu/io/datagen.py``).

Rows of (dna, kmer, qkmer) random sequences in the shape of the
reference's data_generator.py: dna of length 1..N with N drawn once per
dataset, kmer 1..32 over ACGT, qkmer 1..32 over ACGT and 10 IUPAC codes
(no n/u).  The same ``random.Random`` stream as ``kmer_tpu``'s, so both
packages make the same rows from the same seed.
"""

from __future__ import annotations

import random

DNA_CHARS = "ACGT"
QKMER_CHARS = "ACGTRYKMSWBDHV"


def generate_sequence(rng: random.Random, chars: str, max_length: int) -> str:
    length = rng.randint(1, max_length)
    return "".join(rng.choices(chars, k=length))


def generate_test_rows(n_rows: int = 1000, seed: int = 0
                       ) -> list[tuple[str, str, str]]:
    """Rows of (dna, kmer, qkmer) strings in the reference generator's shape."""
    rng = random.Random(seed)
    dna_max = rng.randint(1, 50)  # drawn once, like data_generator.py:15
    return [(generate_sequence(rng, DNA_CHARS, dna_max),
             generate_sequence(rng, DNA_CHARS, 32),
             generate_sequence(rng, QKMER_CHARS, 32))
            for _ in range(n_rows)]


def rows_to_csv(rows, path: str) -> None:
    with open(path, "w") as f:
        f.write("dna,kmer,qkmer\n")
        for dna, kmer, qkmer in rows:
            f.write(f"{dna},{kmer},{qkmer}\n")
