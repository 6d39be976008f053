"""Parity harness: the reference test suite's workloads over the port.

The counterpart of ``kmer_tpu/parity.py``: re-runs every behavioral
golden of kmer-tests.sql (the expected outputs recorded inline in the
reference suite) against ``kmer_tpu_torch``'s own modules and reports
pass/fail per group.  The checks that count, scan or group run on the
``device`` given.  A library (``run_parity(device=...)``) or the CLI
(``python -m kmer_tpu_torch parity [--device cuda]``).
"""

from __future__ import annotations

import traceback
from typing import Callable

import torch

from .device import resolve_device
from .errors import (
    InvalidDnaSequenceError,
    InvalidKmerLengthError,
    InvalidQkmerSequenceError,
    KmerTooLongError,
    QkmerTooLongError,
)


def _raises(fn, exc, msg):
    try:
        fn()
    except exc as e:
        assert str(e) == msg, f"error message {str(e)!r} != {msg!r}"
        return
    raise AssertionError(f"expected {exc.__name__}")


def _t1_dna(device):
    from .types import Dna

    assert str(Dna("AAAACCCCGGGGTTTT")) == "aaaaccccggggtttt"  # kmer-tests.sql:12-17
    assert str(Dna("ACGTTGCA")) == "acgttgca"
    _raises(lambda: Dna("ACGTN"), InvalidDnaSequenceError, "Invalid DNA Sequence")


def _t2_kmer(device):
    from .types import Kmer

    assert (
        str(Kmer("AAAACCCCGGGGTTTTAAAACCCCGGGGTTTT"))
        == "aaaaccccggggttttaaaaccccggggtttt"
    )  # :51-57
    _raises(
        lambda: Kmer("AAAAAAAACCCCCCCCGGGGGGGGTTTTTTTTT"),
        KmerTooLongError,
        "KMer Sequence larger than length 32",
    )  # :70-77
    _raises(lambda: Kmer("AGTCN"), InvalidDnaSequenceError, "Invalid DNA Sequence")


def _t3_qkmer(device):
    from .types import Qkmer

    assert str(Qkmer("ACGT")) == "acgt"  # :99-105
    _raises(
        lambda: Qkmer("AAAAAAAACCCCCCCCGGGGGGGGTTTTTTTTT"),
        QkmerTooLongError,
        "QKMer Sequence larger than length 32",
    )
    _raises(lambda: Qkmer("ACGT123"), InvalidQkmerSequenceError, "Invalid QKMer Sequence")


def _t4_length(device):
    from .ops.predicates import length
    from .types import Dna, Kmer, Qkmer

    assert length(Dna("ACGTACGT")) == 8  # :148-154
    assert length(Kmer("ACGTACGT")) == 8
    assert length(Qkmer("RYN")) == 3
    assert length(Dna("")) == 0 and length(Kmer("")) == 0 and length(Qkmer("")) == 0


def _t5_generate(device):
    from .ops.extract import extract_to_strings, generate_kmers

    _raises(lambda: generate_kmers("ACGT", 0), InvalidKmerLengthError, "Invalid KMER Length")
    _raises(lambda: generate_kmers("AC", 5), InvalidKmerLengthError, "Invalid KMER Length")
    assert extract_to_strings("ACGTACGT", 3) == ["acg", "cgt", "gta", "tac", "acg", "cgt"]
    assert extract_to_strings("ACGTACGT", 8) == ["acgtacgt"]  # :287-296


def _t67_equals(device):
    from .ops.predicates import equals

    assert equals("ACGTACGT", "ACGTACGT") is True  # :315
    assert equals(None, "ACGTA") is None and equals(None, None) is None
    assert equals("", None) is None
    assert equals("", "") is True and equals("A", "") is False


def _t89_starts_with(device):
    from .ops.predicates import starts_with, starts_with_op

    assert starts_with("ACG", "ACGTACGT") is True
    assert starts_with(None, "ACGT") is None and starts_with("ACGT", None) is None
    assert starts_with("", "AGT") is True
    assert starts_with("ACGTACGT", "AC") is False
    assert starts_with_op("ACGTACGT", "ACG") is True
    assert starts_with_op("ACGT", "AC") is True
    assert starts_with_op("", "AGT") is False
    assert starts_with_op("AC", "ACGTACGT") is False


def _t1011_contains(device):
    from .ops.predicates import contains, containing

    assert contains("ACNTANGT", "ACGTACGT") is True
    assert contains(None, "ACGT") is None and contains("ACGT", None) is None
    assert contains("", "AGT") is False
    assert contains("ACGTACGT", "AC") is False
    assert contains("ACG", "ACGTACGT") is False
    assert contains("RCGT", "ACGT") is True
    assert containing("ACGT", "RCGT") is True
    # quirk: u accepted, matches nothing (kmer.h:50-51)
    for b in "ACGT":
        assert contains("U", b) is False


def _t1213_count_group(device):
    from .ops.count import count_dna

    t = count_dna("ACGTACGT", 4, device=device)
    assert t.total() == 5  # TEST 12.1
    assert t.to_dict() == {"tacg": 1, "acgt": 2, "cgta": 1, "gtac": 1}  # TEST 13.1


def _t14_index_equivalence(device):
    from .api import KmerTable
    from .io import generate_test_rows

    table = KmerTable.from_rows(generate_test_rows(500, seed=14),
                                device=device)
    probes_eq = ["acga", "a", ""]
    probes_pre = ["", "ac", "acga"]
    probes_pat = ["angry", "nn", "r"]
    scan = (
        {q: set(table.scan_eq(q)) for q in probes_eq},
        {q: set(table.scan_prefix(q)) for q in probes_pre},
        {q: set(table.scan_pattern(q)) for q in probes_pat},
    )
    table.create_index()
    for q in probes_eq:
        assert set(table.where_eq(q)) == scan[0][q]
    for q in probes_pre:
        assert set(table.where_prefix(q)) == scan[1][q]
    for q in probes_pat:
        assert set(table.where_pattern(q)) == scan[2][q]


def _t15_joins(device):
    """kmer-test.sql:104-407's join matrix shapes vs nested-loop oracles."""
    from .io import generate_test_rows
    from .joins import join_eq, join_pattern, join_right_starts_with_left, outer_extend
    from .ops.predicates import contains, equals, starts_with
    from .packed import PackedKmers
    from .types import Qkmer

    rows = generate_test_rows(160, seed=15)
    left = [r[1].lower() for r in rows[:80]]
    right = [r[1].lower() for r in rows[80:]] + left[:10]  # guarantee matches
    L, R = PackedKmers.from_strings(left), PackedKmers.from_strings(right)

    got = [tuple(p) for p in join_eq(L, R)]
    want = sorted((i, j) for i, a in enumerate(left)
                  for j, b in enumerate(right) if equals(a, b))
    assert got == want
    # LEFT JOIN row count: matches + unmatched-left null rows
    rows_left = outer_extend(join_eq(L, R), len(left), len(right), "left")
    matched_left = {i for i, _ in want}
    assert len(rows_left) == len(want) + (len(left) - len(matched_left))

    got = [tuple(p) for p in join_right_starts_with_left(L, R)]
    want = sorted((i, j) for i, a in enumerate(left)
                  for j, b in enumerate(right) if starts_with(a, b))
    assert got == want

    qk = [Qkmer(r[2]) for r in rows[:40]]
    got = [tuple(p) for p in join_pattern(qk, R)]
    want = sorted((i, j) for i, q in enumerate(qk)
                  for j, b in enumerate(right) if contains(q, b))
    assert got == want


CHECKS: list[tuple[str, Callable[[torch.device], None]]] = [
    ("TEST 1: dna type", _t1_dna),
    ("TEST 2: kmer type", _t2_kmer),
    ("TEST 3: qkmer type", _t3_qkmer),
    ("TEST 4: length", _t4_length),
    ("TEST 5: generate_kmers", _t5_generate),
    ("TEST 6-7: equals/=", _t67_equals),
    ("TEST 8-9: starts_with/^@", _t89_starts_with),
    ("TEST 10-11: contains/@>/<@", _t1011_contains),
    ("TEST 12-13: count/group by", _t1213_count_group),
    ("TEST 14: index == scan", _t14_index_equivalence),
    ("kmer-test.sql joins", _t15_joins),
]


def run_parity(verbose: bool = True, *, device) -> bool:
    """Every check of CHECKS, the device ones on ``device``; prints PASS or
    FAIL (with the traceback) per check and returns whether all passed."""
    if not __debug__:
        raise RuntimeError("the parity checks are asserts: run without -O")
    device = resolve_device(device)
    ok = True
    for name, fn in CHECKS:
        try:
            fn(device)
            if verbose:
                print(f"PASS  {name}")
        except Exception:
            ok = False
            print(f"FAIL  {name}")
            traceback.print_exc()
    return ok


# --- scale parity (kmer-tests.sql TEST 14 at its real size) -------------------
#
# The reference's evidence is 100k-row behavior: CSV COPY + seq-scan vs
# index-scan equivalence (kmer-tests.sql:1229-1353) and GROUP BY over the
# full table (:1158-1214).  run_scale_parity replays that at any row
# count against randomized probes and a pure-Python oracle;
# `python -m kmer_tpu_torch parity --scale 100000` is the CLI form.


# IUPAC code -> the bases it matches ('u' is accepted and matches none)
_IUPAC_BASES = {
    "a": "a", "c": "c", "g": "g", "t": "t", "u": "", "r": "ag", "y": "ct",
    "k": "gt", "m": "ac", "s": "cg", "w": "at", "b": "cgt", "d": "agt",
    "h": "act", "v": "acg", "n": "acgt",
}


def _scale_oracles(rows, probes_eq, probes_pre, probes_pat):
    """Brute-force model of the reference semantics on lowercase strings,
    row by row in pure Python and independent of the engine's codec and
    predicates: = is string equality, ^@ ``str.startswith``, @> equal
    length with every base in its position's IUPAC set."""
    import collections

    kmers = [r[1].lower() for r in rows]
    eq = {q: {i for i, s in enumerate(kmers) if s == q} for q in probes_eq}
    pre = {q: {i for i, s in enumerate(kmers) if s.startswith(q)}
           for q in probes_pre}
    pat = {q: {i for i, s in enumerate(kmers) if len(s) == len(q) and all(
        b in _IUPAC_BASES[c] for c, b in zip(q, s))} for q in probes_pat}
    group = dict(collections.Counter(kmers))
    return eq, pre, pat, group


def run_scale_parity(
    n_rows: int = 100_000, seed: int = 100, n_probes: int = 48,
    verbose: bool = True, *, device,
) -> bool:
    """Reference-scale equivalence: CSV round trip, scan == index == oracle
    on all four operators, GROUP BY == Counter oracle.

    Matches kmer-tests.sql:1229-1353 (TEST 14 at 100k rows) and
    :1107-1214 (TEST 12-13) without a Postgres install: the oracle is a
    per-row pure-Python evaluation of the reference semantics.  The
    table's scans and GROUP BY run on ``device``.
    """
    import os
    import random
    import tempfile

    from .api import KmerTable
    from .io import generate_test_rows, rows_to_csv

    rows = generate_test_rows(n_rows, seed=seed)

    # CSV COPY round trip (kmer-tests.sql:1229-1233)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sequences.csv")
        rows_to_csv(rows, path)
        table = KmerTable.from_csv(path, device=resolve_device(device))
    if len(table) != n_rows:
        raise RuntimeError("CSV round trip dropped rows")

    rng = random.Random(seed + 1)
    stored = [r[1].lower() for r in rows]
    probes_eq = [stored[rng.randrange(n_rows)] for _ in range(n_probes)]
    probes_eq += ["acga", "", "t" * 32, "c" * 31]  # likely-absent + edges
    probes_pre = [s[: rng.randint(1, len(s))] for s in probes_eq[:n_probes] if s]
    probes_pre += ["", "a", "acga", "t" * 32]
    probes_pat = [r[2].lower() for r in rows[:: max(1, n_rows // n_probes)]][
        :n_probes
    ]
    probes_pat += ["n" * 8, "angry", "u", "r" * 32]

    eq_o, pre_o, pat_o, group_o = _scale_oracles(
        rows, set(probes_eq), set(probes_pre), set(probes_pat)
    )

    ok = True

    def check(name, cond):
        nonlocal ok
        if not cond:
            ok = False
            print(f"FAIL  scale: {name}")
        elif verbose:
            print(f"PASS  scale: {name}")

    # scan path vs oracle
    check("scan = (eq)", all(
        set(table.scan_eq(q).tolist()) == eq_o[q] for q in set(probes_eq)
    ))
    check("scan ^@ (prefix)", all(
        set(table.scan_prefix(q).tolist()) == pre_o[q] for q in set(probes_pre)
    ))
    check("scan @> (pattern)", all(
        set(table.scan_pattern(q).tolist()) == pat_o[q] for q in set(probes_pat)
    ))

    # index path == scan path (TEST 14 equivalence at scale)
    table.create_index()
    check("index = == scan", all(
        set(table.where_eq(q).tolist()) == eq_o[q] for q in set(probes_eq)
    ))
    check("index ^@ == scan", all(
        set(table.where_prefix(q).tolist()) == pre_o[q] for q in set(probes_pre)
    ))
    check("index @> == scan", all(
        set(table.where_pattern(q).tolist()) == pat_o[q] for q in set(probes_pat)
    ))

    # GROUP BY / COUNT / DISTINCT vs Counter oracle (TEST 12-13)
    got_group = table.group_by_kmer().to_dict()
    check("GROUP BY == Counter", got_group == group_o)
    check("COUNT(*)", table.count() == n_rows)
    check("COUNT(DISTINCT)", table.distinct_kmers() == len(group_o))

    if verbose:
        print(f"scale parity at {n_rows} rows: {'OK' if ok else 'FAILED'}")
    return ok
