"""The FASTA parses' thread split (``csrc/host_parse.c``): a record longer
than a thread's range is split at line starts, not only at record starts.
Every case is a buffer above the parsers' 1 MiB threshold, parsed by
``native.fasta_encode`` ("skip") and ``native.contigs_encode`` ("break")
at 1, 2, 3, 8 and 16 threads and held byte for byte (codes, offsets,
``breaks``, gap bytes) to the same parse on one thread; the bounds the
parse took (``native.splits()``) are held to a plain model of the split
rule written here; and ``count_file`` on a one-record FASTA is held to
``kmer_tpu``'s table ("skip") and to the one-thread parse's ("break")."""

from __future__ import annotations

import functools
import zlib

import numpy as np
import pytest

import kmer_tpu.pipeline as jp
from kmer_tpu_torch import native
from kmer_tpu_torch.errors import InvalidDnaSequenceError
from kmer_tpu_torch.pipeline import count_file

THREADS = [1, 2, 3, 8, 16]
POLICIES = ["skip", "break"]
MIN_SPLIT = 1 << 20  # below it the parsers run on one thread
ACGT = frozenset(b"ACGTacgt")
IUPAC = b"NRYKMSWBDHVn"


def _bases(rng, n: int, alphabet: bytes = b"ACGT") -> np.ndarray:
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, a.size, n)]


def _runs(rng, seq: np.ndarray, count: int, longest: int) -> np.ndarray:
    """``seq`` with ``count`` runs of N (1 to ``longest``) at seeded places."""
    seq = seq.copy()
    for s, length in zip(rng.integers(0, seq.size, count),
                         rng.integers(1, longest + 1, count)):
        seq[s: s + length] = ord("N")
    return seq


def _lines(seq: np.ndarray, width: int, eol: bytes = b"\n",
           final: bool = True) -> bytes:
    """``seq`` as lines of ``width`` bytes ended by ``eol``; the last line
    unended unless ``final``."""
    full = seq.size // width
    e = np.frombuffer(eol, np.uint8)
    body = np.concatenate(
        [seq[: full * width].reshape(full, width),
         np.broadcast_to(e, (full, e.size))], axis=1).tobytes()
    tail = seq[full * width:].tobytes()
    out = body + (tail + eol if tail else b"")
    return out if final else out[: -len(eol)]


def _candidates(n: int) -> list[int]:
    """Every ``n*t/T`` of the thread counts tested."""
    return sorted({n * t // T for T in THREADS for t in range(1, T)})


def _near_bounds(buf: bytearray, chars: bytes, rng, reach: int) -> None:
    """Overwrite the sequence bytes within ``reach`` of the first line
    start after every ``n*t/T`` with bytes drawn from ``chars``."""
    for pos in _candidates(len(buf)):
        b = buf.index(b"\n", pos) + 1
        for i in range(b - reach, min(b + reach, len(buf))):
            if buf[i] not in b"\r\n>":
                buf[i] = chars[rng.integers(0, len(chars))]


def _short_records(rng, n: int) -> bytes:
    lens = rng.integers(20, 200, n)
    seq = _bases(rng, int(lens.sum()), b"ACGTN")
    ends = np.cumsum(lens)
    return b"".join(b">s%d\n" % i + _lines(seq[e - ln: e], 60)
                    for i, (e, ln) in enumerate(zip(ends, lens)))


def _case_lines60(rng):
    return b">chr1 one record\n" + _lines(
        _runs(rng, _bases(rng, 1_900_000), 40, 300), 60)


def _case_lines1(rng):
    return b">one base a line\n" + _lines(
        _runs(rng, _bases(rng, 640_000), 40, 5), 1)


def _case_crlf(rng):
    return b">crlf\r\n" + _lines(
        _runs(rng, _bases(rng, 1_500_000), 30, 200), 60, b"\r\n")


def _case_no_final_newline(rng):
    return b">open\n" + _lines(_bases(rng, 1_700_003), 70, final=False)


def _case_gt_mid_line(rng):
    """'>' inside lines: at the end of the line before each first line
    start after an ``n*t/T``, a few bytes into that line, and at seeded
    places; each begins a header that runs to the line's end."""
    buf = bytearray(b">gt\n" + _lines(_bases(rng, 1_800_000), 60))
    places = [p for pos in _candidates(len(buf))
              for b in [buf.index(b"\n", pos) + 1] for p in (b - 5, b + 3)]
    for i in [*places, *rng.integers(10, len(buf), 40)]:
        if buf[i - 1] != ord("\n") and buf[i] != ord("\n"):
            buf[i] = ord(">")
    return bytes(buf)


def _case_lowercase_iupac(rng):
    seq = _runs(rng, _bases(rng, 1_600_000, b"ACGTacgt"), 60, 400)
    buf = bytearray(b">mixed case\n" + _lines(seq, 60))
    _near_bounds(buf, IUPAC, rng, 4)
    return bytes(buf)


def _case_n_line_starts(rng):
    """Every line begins in N, half of them end in N too: under "break"
    no line start has a contig running across it (merged)."""
    seq = _bases(rng, 1_500_000).reshape(-1, 60)
    seq[:, 0] = ord("N")
    seq[::2, 59] = ord("N")
    return b">gaps at every line\n" + _lines(seq.reshape(-1), 60)


def _case_n_line_ends(rng):
    """Every line ends in N and begins with a base: under "break" each
    line start has a gap pending (merged)."""
    seq = _bases(rng, 1_500_000).reshape(-1, 60)
    seq[:, 59] = ord("N")
    return b">gap at every line end\n" + _lines(seq.reshape(-1), 60)


def _case_leading_blank_lines(rng):
    """Headerless, after 1.2 MB of blank and CR-only lines: no read has
    begun at a line start among them, so no range starts there."""
    return (b"\n\r\n" * 400_000
            + _lines(_runs(rng, _bases(rng, 300_000), 10, 50), 60))


def _case_one_line(rng):
    """No line start after the header: merged under both policies."""
    return b">one line\n" + _bases(rng, 1_300_000, b"ACGTN").tobytes() + b"\n"


def _case_headerless(rng):
    return _lines(_runs(rng, _bases(rng, 1_400_000), 20, 100), 60)


def _case_long_and_short(rng):
    return (_short_records(rng, 3000)
            + b">long\n" + _lines(_runs(rng, _bases(rng, 1_200_000), 20, 90),
                                  60)
            + _short_records(rng, 1000))


def _case_blank_lines(rng):
    """Blank and CR-only lines every few lines: a range may not start
    after one (the read's state is not read from a blank line)."""
    lines = _lines(_bases(rng, 1_500_000), 60).split(b"\n")
    for i in range(0, len(lines), 7):
        lines[i] += b"\n" + (b"\r" if i % 14 else b"")
    return b">blanks\n" + b"\n".join(lines)


CASES = {name[len("_case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("_case_")}


@functools.cache
def case_bytes(name: str) -> bytes:
    data = CASES[name](np.random.default_rng(zlib.crc32(name.encode())))
    assert len(data) > MIN_SPLIT
    return data


def _parse(data: bytes, policy: str, threads: int, monkeypatch):
    """The policy's parse of ``data`` on ``threads`` threads, as
    (codes, offsets, breaks, gap bytes), and the splits it took."""
    monkeypatch.setattr(native, "_parse_threads", lambda: threads)
    native.zero_splits()
    if policy == "skip":
        out = (*native.fasta_encode(data), 0, 0)
    else:
        out = native.contigs_encode(data, "fasta")
    return out, native.splits()


@functools.cache
def one_thread(name: str, policy: str):
    with pytest.MonkeyPatch.context() as mp:
        return _parse(case_bytes(name), policy, 1, mp)[0]


def model_splits(data: bytes, threads: int, policy: str) -> dict[str, int]:
    """The split rule, written plainly: interior bound t looks in range t,
    [n*t/T, n*(t+1)/T), first for a record start, then for a line start
    inside a record whose previous line holds a byte but '\\r'; under
    "break" also the previous line's last byte
    (past '\\r') and this line's first are bases."""
    out = dict.fromkeys(native.SPLIT_KINDS, 0)
    n = len(data)
    if threads < 2 or n < MIN_SPLIT:
        return out
    for t in range(1, threads):
        pos, lim = n * t // threads, n * (t + 1) // threads
        if data.find(b"\n>", pos - 1, lim) >= 0:
            out["record"] += 1
            continue
        b = pos if data[pos - 1] == ord("\n") else data.find(b"\n", pos,
                                                             lim) + 1
        while 0 < b < lim and not _line_start_ok(data, b, policy):
            b = data.find(b"\n", b, lim) + 1
        out["line" if 0 < b < lim else "merged"] += 1
    return out


def _line_start_ok(data: bytes, b: int, policy: str) -> bool:
    prev = data[data.rfind(b"\n", 0, b - 1) + 1: b - 1].rstrip(b"\r")
    if not prev:
        return False
    if policy == "skip":
        return True
    return prev[-1] in ACGT and data[b] in ACGT


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_parse_is_the_one_thread_parse(name, policy, threads,
                                             monkeypatch):
    got, _ = _parse(case_bytes(name), policy, threads, monkeypatch)
    want = one_thread(name, policy)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2:] == want[2:]


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_splits_count_the_bounds_taken(name, policy, threads, monkeypatch):
    data = case_bytes(name)
    _, got = _parse(data, policy, threads, monkeypatch)
    assert got == model_splits(data, threads, policy)
    interior = threads - 1
    if name in ("lines60", "lines1", "crlf", "headerless", "blank_lines"):
        assert got["line"] == interior
    if name == "one_line" or (name.startswith("n_line_")
                              and policy == "break"):
        assert got["merged"] == interior
    if name == "long_and_short" and threads >= 8:
        assert got["record"] >= 1 and got["line"] >= 1


def test_the_model_sees_every_kind():
    """The cases reach every kind of bound under the model itself."""
    seen = {kind for name in CASES for policy in POLICIES
            for kind, n in model_splits(case_bytes(name), 8, policy).items()
            if n}
    assert seen == set(native.SPLIT_KINDS)


def _first_bad_byte(data: bytes, threads: int) -> int:
    """``kb_fasta_encode_mt``'s return with ``skip_invalid`` off."""
    n = len(data)
    codes = np.empty(n, np.uint8)
    offsets = np.empty(n // 3 + 17, np.int64)
    found = np.zeros(len(native.SPLIT_KINDS), np.int64)
    return native._load().kb_fasta_encode_mt(
        data, n, codes.ctypes.data_as(native._u8p),
        offsets.ctypes.data_as(native._i64p), n // 3 + 16, 0, threads,
        found.ctypes.data_as(native._i64p))


def _planted(rng) -> tuple[bytes, int]:
    """One record of clean bases with 'N' in its header and bad bytes
    planted in the last ranges; the first of them, and the buffer."""
    buf = bytearray(b">NNN header\n" + _lines(_bases(rng, 1_600_000), 60))
    places = []
    for pos in rng.integers(len(buf) // 2, len(buf), 12):
        i = int(pos)
        while buf[i] in b"\n":
            i += 1
        buf[i] = ord("X")
        places.append(i)
    return bytes(buf), min(places)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize(
    "name", ["planted", "lines60", "lowercase_iupac", "headerless"])
def test_strict_parse_reports_the_first_bad_byte(name, threads, monkeypatch):
    if name == "planted":
        data, first = _planted(np.random.default_rng(24))
        assert _first_bad_byte(data, 1) == -first - 1
    else:
        data = case_bytes(name)
    want = _first_bad_byte(data, 1)
    assert want < 0
    assert _first_bad_byte(data, threads) == want
    monkeypatch.setattr(native, "_parse_threads", lambda: threads)
    with pytest.raises(InvalidDnaSequenceError):
        native.fasta_encode(data, skip_invalid=False)


K = 21


@pytest.fixture(scope="module")
def one_record_fasta(tmp_path_factory):
    rng = np.random.default_rng(2401)
    path = tmp_path_factory.mktemp("split") / "chr.fasta"
    data = b">chr\n" + _lines(_runs(rng, _bases(rng, 2_200_000), 25, 400), 60)
    assert len(data) >= 2 << 20
    path.write_bytes(data)
    return str(path)


def _sorted(hi, lo, counts) -> np.ndarray:
    """[2, rows] of (64-bit key, count), ordered by key."""
    keys = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64))
    order = np.argsort(keys)
    return np.stack([keys[order],
                     np.asarray(counts).astype(np.uint64)[order]])


def _count(path: str, policy: str) -> np.ndarray:
    hi, lo, length, count_hi, count_lo = count_file(
        path, "fasta", K, canonical=True, device="cpu",
        n_policy=policy).trim().to_numpy()
    assert (length == K).all()
    return _sorted(hi, lo, (count_hi.astype(np.uint64) << np.uint64(32))
                   + count_lo)


@pytest.mark.parametrize("policy", POLICIES)
def test_count_file_on_one_record_is_unchanged_by_the_split(
        one_record_fasta, policy, monkeypatch):
    monkeypatch.setattr(native, "_parse_threads", lambda: 8)
    native.zero_splits()
    got = _count(one_record_fasta, policy)
    assert native.splits()["line"] >= 7
    if policy == "skip":
        t = jp.count_file(one_record_fasta, "fasta", K, canonical=True,
                          batch=4096, width=1024).trim()
        assert (np.asarray(t.length) == K).all()
        want = _sorted(t.hi, t.lo, t.counts64() if hasattr(t, "counts64")
                       else t.counts)
    else:
        monkeypatch.setattr(native, "_parse_threads", lambda: 1)
        want = _count(one_record_fasta, policy)
    assert np.array_equal(got, want)
