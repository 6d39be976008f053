"""``n_policy="break"``: windows break at every run of non-ACGT sequence
bytes, as jellyfish, meryl and KMC count, in both formats and on both
routes of ``count_file``, against a plain rule written here (split each
record's sequence at non-ACGT bytes, count each piece alone).  The default
``"skip"`` is held to ``kmer_tpu`` by the parity tests elsewhere."""

from __future__ import annotations

import collections
import re

import numpy as np
import pytest

from kmer_tpu_torch import cli
from kmer_tpu_torch.native import contigs_encode, fasta_encode, fastq_encode
from kmer_tpu_torch.pipeline import count_file
from kmer_tpu_torch.utils.logging import StatsCounters

CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
SPLIT = re.compile(r"[^ACGTacgt]+")


def plain_contigs(records: list[str]) -> list[str]:
    """Each record's maximal ACGT runs (upper case), a record with none
    as one empty contig; the plain rule."""
    out = []
    for seq in records:
        pieces = [p.upper() for p in SPLIT.split(seq) if p]
        out.extend(pieces or [""])
    return out


def plain_table(records: list[str], k: int, canonical: bool
                ) -> dict[int, int]:
    """{left-aligned 64-bit key: count} of every window of every contig."""
    table: collections.Counter = collections.Counter()
    shift = 64 - 2 * k
    for contig in plain_contigs(records):
        for i in range(len(contig) - k + 1):
            w = contig[i: i + k]
            fwd = 0
            rc = 0
            for j, ch in enumerate(w):
                fwd = (fwd << 2) | CODE[ch]
                rc |= (3 - CODE[ch]) << (2 * j)
            table[(min(fwd, rc) if canonical else fwd) << shift] += 1
    return dict(table)


def program_table(result, k: int) -> dict[int, int]:
    lanes = result.trim().to_numpy()
    hi, lo, length = (np.asarray(a) for a in lanes[:3])
    if len(lanes) == 5:
        counts = (lanes[3].astype(np.int64) << 32) + lanes[4].astype(np.int64)
    else:
        counts = lanes[3].astype(np.int64)
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    assert (length == k).all()
    return {int(a): int(c) for a, c in zip(keys, counts)}


def inner_runs(records: list[str]) -> int:
    """Contigs begun at a run inside a record."""
    return sum(max(len([p for p in SPLIT.split(s) if p]) - 1, 0)
               for s in records)


def fasta_bytes(records: list[str], line: int = 60) -> bytes:
    parts = []
    for i, seq in enumerate(records):
        lines = [seq[s: s + line] for s in range(0, len(seq), line)] or [""]
        parts.append(f">rec_{i}\n" + "\n".join(lines) + "\n")
    return "".join(parts).encode()


def fastq_bytes(records: list[str]) -> bytes:
    return "".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                   for i, s in enumerate(records)).encode()


def write(tmp_path, fmt: str, records: list[str]) -> str:
    path = str(tmp_path / f"in.{fmt}")
    with open(path, "wb") as f:
        f.write(fasta_bytes(records) if fmt == "fasta"
                else fastq_bytes(records))
    return path


def random_records(seed: int, n: int, length: int, gaps: str = "N",
                   p_gap: float = 0.03) -> list[str]:
    """Seeded records of ACGT (some lower case) with runs of ``gaps``
    letters of lengths 1-120 laid over them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        L = int(rng.integers(length // 2, length + 1))
        seq = list(np.array(list("ACGTacgt"))[rng.integers(0, 8, L)])
        i = 0
        while i < L:
            if rng.random() < p_gap:
                run = int(rng.choice([1, 2, 5, 100, 120]))
                for j in range(i, min(L, i + run)):
                    seq[j] = gaps[int(rng.integers(0, len(gaps)))]
                i += run
            i += int(rng.integers(1, 60))
        out.append("".join(seq))
    return out


EDGE_RECORDS = {
    # runs of 1 and of 100 at a record's start and end, and inside
    "ends_1": ["N" + "ACGTTGCAAC" * 5 + "N", "ACGT" * 10],
    "ends_100": ["N" * 100 + "GATTACA" * 9 + "N" * 100 + "CCGGA" * 7
                 + "N" * 100],
    "inner_1_and_100": ["ACGTACGGTCA" * 4 + "N" + "TTGACCA" * 5 + "N" * 100
                        + "GGCATT" * 6],
    # contigs shorter than k give nothing; a record of runs only is empty
    "short_contigs": ["ACG" + "N" + "ACGTA" + "NN" + "T" + "N" * 3
                      + "ACGTACGTACGTACGTACGTACGTACGTACGTACGTAC", "NNNN",
                      "", "AC"],
    # lower-case n and IUPAC letters break as N does; lower-case acgt are
    # bases
    "lowercase_and_iupac": ["acgtacgtaacc" * 3 + "n" + "ggtacca" * 6 + "R"
                            + "ACGTTGCA" * 5 + "YKMSWBDHV"
                            + "tgcatgcaat" * 4 + "nNn" + "CAGT" * 9],
}


def _cases():
    cases = [(name, recs) for name, recs in EDGE_RECORDS.items()]
    cases.append(("random_n", random_records(3, 12, 400)))
    cases.append(("random_iupac", random_records(4, 12, 400,
                                                 gaps="NnRYKMSWBDHV-.*")))
    return cases


CASES = _cases()


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
@pytest.mark.parametrize("name,records", CASES, ids=[c[0] for c in CASES])
def test_parse_emits_one_read_a_contig(name, records, fmt):
    data = fasta_bytes(records) if fmt == "fasta" else fastq_bytes(records)
    codes, offs, breaks, gaps = contigs_encode(data, fmt)
    got = ["".join("ACGT"[c] for c in codes[a:b])
           for a, b in zip(offs[:-1], offs[1:])]
    assert got == plain_contigs(records)
    seq_bytes = sum(len(s) for s in records)
    assert gaps == seq_bytes - codes.size
    assert breaks == inner_runs(records)
    # the same bytes, skipped, give the same codes with the records' own
    # offsets
    skip = (fasta_encode if fmt == "fasta" else fastq_encode)(data)
    assert np.array_equal(skip[0], codes)
    assert skip[1].size == len(records) + 1


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_threaded_parse_of_many_records(fmt):
    """Above 1 MiB the parse runs on threads split at record starts; the
    contigs are the plain rule's all the same."""
    records = random_records(11, 900, 2400, gaps="NnRY", p_gap=0.02)
    data = fasta_bytes(records) if fmt == "fasta" else fastq_bytes(records)
    assert len(data) > (1 << 20)
    codes, offs, breaks, gaps = contigs_encode(data, fmt)
    want = plain_contigs(records)
    lens = np.diff(offs)
    assert lens.tolist() == [len(c) for c in want]
    joined = "".join(want)
    assert "".join("ACGT"[c] for c in codes) == joined
    assert breaks == inner_runs(records)
    assert gaps == sum(len(s) for s in records) - len(joined)


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_many_contigs_past_the_first_offsets_guess(fmt):
    """A record of one base a contig: more contigs than the parse's first
    guess of the offsets it needs, which it then sizes and parses again."""
    records = ["AN" * 4000]
    data = fasta_bytes(records) if fmt == "fasta" else fastq_bytes(records)
    codes, offs, breaks, gaps = contigs_encode(data, fmt)
    assert offs.size == 4001 and codes.size == 4000
    assert breaks == 3999 and gaps == 4000


KS = [(1, False), (1, True), (21, True), (21, False), (31, True),
      (32, True), (32, False)]


@pytest.mark.parametrize("batch", [None, 32],
                         ids=["one-batch", "many-batches"])
@pytest.mark.parametrize("k,canonical", KS)
@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_count_file_breaks_at_runs(tmp_path, fmt, k, canonical, batch):
    """The whole small file in one auto-sized batch, or in many."""
    records = [*random_records(k * 7 + 1, 10, 500)]
    for recs in EDGE_RECORDS.values():
        records.extend(recs)
    path = write(tmp_path, fmt, records)
    stats = StatsCounters()
    res = count_file(path, fmt, k, canonical=canonical, device="cpu",
                     n_policy="break", batch=batch, stats=stats)
    if batch is None:
        assert stats.batches == 1
    assert program_table(res, k) == plain_table(records, k, canonical)
    assert stats.breaks == inner_runs(records)
    assert stats.break_bases == sum(len(s) for s in records) - sum(
        len(c) for c in plain_contigs(records))


@pytest.mark.parametrize("chunk_bytes", [64, 700, 4096])
@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_runs_across_chunk_boundaries(tmp_path, fmt, chunk_bytes):
    """Small ingest chunks cut the file inside records and inside their
    runs; the carry keeps each record whole."""
    records = random_records(chunk_bytes, 30, 300, p_gap=0.08)
    path = write(tmp_path, fmt, records)
    res = count_file(path, fmt, 21, canonical=True, device="cpu",
                     n_policy="break", batch=16,
                     chunk_bytes=chunk_bytes)
    assert program_table(res, 21) == plain_table(records, 21, True)


@pytest.mark.parametrize("policy", ["skip", "break"])
def test_policies_differ_only_where_a_run_is(tmp_path, policy):
    """Without a non-ACGT byte both policies give the same table; with
    one, "skip" joins the flanks and "break" does not."""
    clean = random_records(5, 6, 300, p_gap=0.0)
    path = write(tmp_path, "fasta", clean)
    res = count_file(path, "fasta", 11, device="cpu", n_policy=policy)
    assert program_table(res, 11) == plain_table(clean, 11, False)
    joined = ["ACGTACGTAC" + "N" * 7 + "GGTTCCAAGT"]
    path = write(tmp_path, "fasta", joined)
    got = program_table(count_file(path, "fasta", 11, device="cpu",
                                   n_policy=policy), 11)
    want = plain_table([joined[0].replace("N", "")] if policy == "skip"
                       else joined, 11, False)
    assert got == want


def test_unknown_policy_raises(tmp_path):
    path = write(tmp_path, "fasta", ["ACGT"])
    with pytest.raises(ValueError, match="n_policy"):
        count_file(path, "fasta", 3, device="cpu", n_policy="mask")


@pytest.mark.parametrize("written,resumed", [("break", "skip"),
                                             ("skip", "break")])
def test_checkpoint_refuses_another_policy(tmp_path, written, resumed):
    records = random_records(21, 20, 400)
    path = write(tmp_path, "fastq", records)
    ck = str(tmp_path / "ck.npz")
    first = count_file(path, "fastq", 15, device="cpu", batch=16,
                       ckpt_path=ck, ckpt_every_s=0.0, n_policy=written)
    from kmer_tpu_torch.pipeline import PipelineCheckpoint

    assert PipelineCheckpoint(ck).meta["n_policy"] == written
    with pytest.raises(ValueError, match=f"n_policy={written}; this resume "
                                         f"uses n_policy={resumed}"):
        count_file(path, "fastq", 15, device="cpu", batch=16, ckpt_path=ck,
                   n_policy=resumed)
    again = count_file(path, "fastq", 15, device="cpu", batch=16,
                       ckpt_path=ck, n_policy=written)
    assert program_table(again, 15) == program_table(first, 15)


def test_cli_count_takes_the_policy(tmp_path, capsys):
    records = EDGE_RECORDS["lowercase_and_iupac"] + EDGE_RECORDS["ends_100"]
    path = write(tmp_path, "fasta", records)
    assert cli.main(["count", "--input", path, "-k", "6", "--canonical",
                     "--n-policy", "break", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.split("\n")
    got = {}
    for line in filter(None, out):
        kmer, n = line.split("\t")
        v = 0
        for ch in kmer.upper():
            v = (v << 2) | CODE[ch]
        got[v << (64 - 12)] = int(n)
    assert got == plain_table(records, 6, True)
