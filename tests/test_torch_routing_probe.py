"""The routing probe (``io.ingest.probe_sample`` under
``pipeline.file_batch_feed``): a bounded sample of the file's start,
scaled to the file by the bytes on disk it used.  Against ``kmer_tpu``'s
probe (width, batch, tables) where the two agree by design, the first
window of the feeder's own ``iter_record_chunks`` on multi-record files,
the true window count where the sample is cut inside a record, and the
plain rule of ``test_torch_n_policy`` (in numpy here) for every table.
"""

from __future__ import annotations

import gzip
import os
import zlib

import numpy as np
import pytest

import kmer_tpu.pipeline as jp
from kmer_tpu_torch import pipeline
from kmer_tpu_torch.io.ingest import (encode_window, iter_encoded_chunks,
                                      iter_record_chunks, probe_sample)
from kmer_tpu_torch.ops.wide import WideCounts
from kmer_tpu_torch.utils.logging import StatsCounters
from kmer_tpu_torch.utils.profiling import Profile
from test_torch_n_policy import (SPLIT, fasta_bytes, fastq_bytes,
                                 plain_contigs, plain_table, program_table,
                                 random_records)

CHUNK = 8192  # so probe_bytes = min(CHUNK, 16 MiB) = 8 KiB
# a deflate stream's first KiB compress worse than the rest (no history
# yet), so a .gz sample of 8 KiB reads ~10% short; at 64 KiB the bias is
# ~3.5%, and at the 16 MiB probe of a real file it is lost
CHUNK_GZ = 64 << 10
PROBE = 16 << 20  # the probe of a default chunk
K = 21
FORMS = [(fmt, gz, policy) for fmt in ("fasta", "fastq")
         for gz in (False, True) for policy in ("skip", "break")]


def _write(tmp_path, name: str, data: bytes, gz: bool,
           member: int | None = None, level: int = 6) -> str:
    """``data`` at ``name``; gzipped at ``level`` when ``gz``, as members
    of ``member`` input bytes each when given (a parallel compressor's
    file), else one member."""
    path = str(tmp_path / (name + (".gz" if gz else "")))
    if gz and member:
        data = b"".join(zlib.compress(data[s: s + member], level, wbits=31)
                        for s in range(0, len(data), member))
    elif gz:
        data = gzip.compress(data, level)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _contigs(records, policy):
    if policy == "break":
        return plain_contigs(records)
    return ["".join(SPLIT.split(s)).upper() for s in records]


def _true_windows(records, policy, k=K) -> int:
    return sum(max(len(c) - k + 1, 0) for c in _contigs(records, policy))


def np_table(records, policy, k=K, canonical=True) -> dict[int, int]:
    """``plain_table`` of the records' contigs under ``policy``, in numpy
    (the same keys: left-aligned, the smaller strand's when canonical)."""
    lut = np.zeros(256, np.uint64)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint64)
    fwd_w = np.uint64(4) ** np.arange(k - 1, -1, -1, dtype=np.uint64)
    rc_w = np.uint64(4) ** np.arange(k, dtype=np.uint64)
    keys = [np.zeros(0, np.uint64)]
    for contig in _contigs(records, policy):
        if len(contig) < k:
            continue
        win = np.lib.stride_tricks.sliding_window_view(
            lut[np.frombuffer(contig.encode(), np.uint8)], k)
        key = win @ fwd_w
        if canonical:
            key = np.minimum(key, (np.uint64(3) - win) @ rc_w)
        keys.append(key << np.uint64(64 - 2 * k))
    uniq, counts = np.unique(np.concatenate(keys), return_counts=True)
    return {int(a): int(c) for a, c in zip(uniq, counts)}


def _jax_table(result, k=K) -> dict[int, int]:
    t = result.trim()
    hi = np.asarray(t.hi, np.uint64)
    lo = np.asarray(t.lo, np.uint64)
    counts = (t.counts64() if hasattr(t, "counts64")
              else np.asarray(t.counts, np.int64))
    assert (np.asarray(t.length) == k).all()
    keys = (hi << np.uint64(32)) | lo
    return {int(a): int(c) for a, c in zip(keys, counts)}


def _probe_read_bytes(prof: Profile) -> int:
    """The bytes read inside the job's ``feed.probe`` spans."""
    probes = {s.id for s in prof.spans if s.name == "feed.probe"}
    assert len(probes) == 1
    return sum(s.nbytes for s in prof.spans
               if s.name == "feed.read" and s.parent in probes)


def _first_window_width(path, fmt, policy, chunk) -> int:
    """The width the first window of the feeder's own chunks gives."""
    _, offs = next(iter_encoded_chunks(path, fmt, chunk, policy))
    return pipeline.auto_width(np.diff(offs))


@pytest.mark.parametrize("policy", ["skip", "break"])
@pytest.mark.parametrize("canonical", [False, True])
def test_numpy_oracle_is_the_plain_rule(policy, canonical):
    records = random_records(3, 30, 300, p_gap=0.05)
    want = plain_table(records if policy == "break"
                       else _contigs(records, "skip"), K, canonical)
    assert np_table(records, policy, K, canonical) == want


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("policy", ["skip", "break"])
def test_one_record_fasta_is_sampled_not_read_whole(tmp_path, gz, policy):
    """A record ~12x the probe: the probe reads at most probe_bytes and
    one byte more, cuts inside the record (one ``probe_cuts``), and
    estimates within 5% of the true windows."""
    chunk = CHUNK_GZ if gz else CHUNK
    records = random_records(3, 1, 12 * chunk, p_gap=0.003)
    path = _write(tmp_path, "one.fasta", fasta_bytes(records), gz)
    true = _true_windows(records, policy)
    _, batch, width, est = pipeline.file_batch_feed(
        path, "fasta", K, None, None, chunk, n_policy=policy)
    assert abs(est - true) <= 0.05 * true
    if policy == "skip":
        assert (batch, width) == jp.file_batch_feed(
            path, "fasta", K, None, None, chunk)[1:3]
    else:  # kmer_tpu has no break; the contigs pass the width cap
        assert (batch, width) == (4096, 1024)
    stats, prof = StatsCounters(), Profile()
    got = pipeline.count_file(path, "fasta", K, canonical=True,
                              chunk_bytes=chunk, device="cpu", stats=stats,
                              profile=prof, n_policy=policy)
    assert _probe_read_bytes(prof) <= chunk + 1
    assert stats.probe_cuts == 1
    want = np_table(records, policy)
    assert program_table(got, K) == want
    if policy == "skip":
        assert _jax_table(jp.count_file(path, "fasta", K, canonical=True,
                                        batch=256, width=512,
                                        chunk_bytes=chunk)) == want


def _many_records(seed: int, n: int, lo: int = 50, hi: int = 400
                  ) -> list[str]:
    """``n`` seeded records of ACGTacgt of ``lo``-``hi`` bases, one in
    ten with a run of 1-120 N at a seeded place."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    bases = np.frombuffer(b"ACGTacgt", np.uint8)[
        rng.integers(0, 8, int(lens.sum()))]
    for i in np.flatnonzero(rng.random(n) < 0.1):
        at = starts[i] + rng.integers(0, lens[i])
        bases[at: min(at + rng.integers(1, 121), starts[i] + lens[i])] = \
            ord("N")
    text = bases.tobytes().decode()
    return [text[a: a + b] for a, b in zip(starts.tolist(), lens.tolist())]


@pytest.fixture(scope="module")
def big_files(tmp_path_factory):
    """{fmt: (records, plain path, .gz path)}: ~20 MB of records, past
    the 16 MiB probe a default chunk gives."""
    d = tmp_path_factory.mktemp("big")
    out = {}
    for fmt, n in (("fasta", 85000), ("fastq", 45000)):
        records = _many_records(11, n)
        data = fasta_bytes(records) if fmt == "fasta" else fastq_bytes(records)
        assert len(data) > 1.2 * PROBE
        out[fmt] = (records, _write(d, f"r.{fmt}", data, False),
                    _write(d, f"r.{fmt}", data, True, level=1))
    return out


@pytest.mark.parametrize("fmt, gz, policy", FORMS)
def test_multi_record_window_width_and_batch_are_the_feeders(
        big_files, fmt, gz, policy):
    """The default 16 MiB probe of a ~20 MB file: the window is the
    feeder's first, cut by the same search near the sample's end, so
    width and batch are kmer_tpu's (on the plain file: kmer_tpu sizes a
    .gz's batch by its compressed size), nothing is cut inside a record,
    and the estimate is the file's windows."""
    records, plain, gzipped = big_files[fmt]
    path = gzipped if gz else plain
    window, disk, cut = probe_sample(path, fmt, PROBE)
    assert window == next(iter_record_chunks(path, fmt, PROBE))
    assert not cut and PROBE - (1 << 20) < len(window) < PROBE
    assert disk == len(window) if not gz else 0 < disk < len(window) / 2
    _, batch, width, est = pipeline.file_batch_feed(
        path, fmt, K, None, None, n_policy=policy)
    want = jp.file_batch_feed(plain, fmt, K, None, None)
    assert batch == want[1]
    assert width == (want[2] if policy == "skip"
                     else _first_window_width(path, fmt, policy, PROBE))
    true = _true_windows(records, policy)
    assert abs(est - true) <= 0.02 * true


@pytest.mark.parametrize("fmt, gz, policy", FORMS)
def test_multi_record_tables(tmp_path, fmt, gz, policy):
    """The table is kmer_tpu's and the plain rule's; an 8 KiB sample of
    many records ends at a record boundary."""
    records = _many_records(13, 300)
    data = fasta_bytes(records) if fmt == "fasta" else fastq_bytes(records)
    path = _write(tmp_path, f"r.{fmt}", data, gz)
    stats = StatsCounters()
    got = pipeline.count_file(path, fmt, K, canonical=True, batch=64,
                              chunk_bytes=CHUNK, device="cpu", stats=stats,
                              n_policy=policy)
    assert stats.probe_cuts == 0
    want = np_table(records, policy)
    assert program_table(got, K) == want
    if policy == "skip":
        assert _jax_table(jp.count_file(path, fmt, K, canonical=True,
                                        batch=64, chunk_bytes=CHUNK)) == want


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_a_read_longer_than_the_sample_stops_at_the_sample(tmp_path, fmt):
    """One read past the probe, with a short one after it: the window is
    the long read's start (for FASTQ its header and sequence line alone,
    which stand for its quality line too), and the estimate holds."""
    records = random_records(5, 1, 60_000, p_gap=0) + ["ACGT" * 30]
    data = fasta_bytes(records) if fmt == "fasta" else fastq_bytes(records)
    path = _write(tmp_path, f"long.{fmt}", data, False)
    window, disk, cut = probe_sample(path, fmt, CHUNK)
    assert cut and len(window) <= CHUNK
    if fmt == "fastq":
        assert window.count(b"\n") == 1 and b"+" not in window
        assert disk == 2 * len(window) - len(b"@r0\n")
    true = _true_windows(records, "skip")
    _, _, width, est = pipeline.file_batch_feed(path, fmt, K, None, None,
                                                CHUNK)
    assert width == 1024 and abs(est - true) <= 0.05 * true
    got = pipeline.count_file(path, fmt, K, canonical=True,
                              chunk_bytes=CHUNK, device="cpu")
    assert program_table(got, K) == np_table(records, "skip")


def _by_compressed_size(path: str, fmt: str, chunk: int) -> int:
    """The sample's windows scaled by the file's compressed size, as
    the probe scaled a .gz before it counted the bytes its sample used."""
    window, _, _ = probe_sample(path, fmt, chunk)
    _, offs = encode_window(window, fmt)
    wins = int(np.maximum(np.diff(offs) - (K - 1), 0).sum())
    return int(wins * os.path.getsize(path) / len(window))


@pytest.mark.parametrize("member", [None, 16 << 10],
                         ids=["one-member", "16KiB-members"])
def test_gz_estimate_scales_by_the_compressed_bytes_used(tmp_path, member):
    """The .gz probe scales by the compressed bytes its sample used, not
    by the file's compressed size: within 10% of the plain file's
    estimate, where the compressed size alone gives under half of it."""
    records = random_records(7, 2000, 150, p_gap=0.0)
    data = fastq_bytes(records)
    plain = _write(tmp_path, "r.fastq", data, False)
    gz = _write(tmp_path, "r.fastq", data, True, member)
    want = pipeline.file_batch_feed(plain, "fastq", K, None, None, CHUNK_GZ)
    got = pipeline.file_batch_feed(gz, "fastq", K, None, None, CHUNK_GZ)
    assert abs(got[3] - want[3]) <= 0.10 * want[3]
    assert got[1:3] == want[1:3]
    assert _by_compressed_size(gz, "fastq", CHUNK_GZ) < want[3] / 2


def test_gz_takes_the_fold_directly(tmp_path):
    """The .gz counts as the plain file does: the same fold batches and
    the same table."""
    chunk = 3 << 19  # past the tail window, as a real probe is
    records = _many_records(9, 7000, 75, 150)
    data = fastq_bytes(records)
    assert len(data) > chunk
    plain = _write(tmp_path, "r.fastq", data, False)
    gz = _write(tmp_path, "r.fastq", data, True, 1 << 20)
    kw = dict(canonical=True, batch=1024, width=160, chunk_bytes=chunk)
    runs = {}
    for path in (plain, gz):
        stats = StatsCounters()
        got = pipeline.count_file(path, "fastq", K, device="cpu",
                                  stats=stats, **kw)
        assert isinstance(got, WideCounts)
        runs[path] = (stats.batches, program_table(got, K))
    assert runs[gz] == runs[plain]
    want = np_table(records, "skip")
    assert runs[gz][1] == want
    assert _jax_table(jp.count_file(gz, "fastq", K, **kw)) == want
