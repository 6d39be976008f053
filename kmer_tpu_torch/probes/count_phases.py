"""``count_file`` split up: ``scripts/probe_r5b.py``, ``probe_r5c.py`` and
``probe_r5e.py`` on the port.

The workload is the scripts' 313 MB FASTQ: ``runs.ingest.write_fastq(path,
1_000_000, seed=7)``, byte for byte ``probe_ingest_rss``'s
``small.fastq`` (1M x 150 bp reads of a 5 Mbp genome): 130,000,000
canonical 21-mers in 4,999,967 groups.

* cold: ``count_file``'s first call in this family (in a process of its
  own, the first use of the kernels, their build included when the
  checkout has none);
* r5b 1: the upload of 4, 12 and 40 MB through the engine's path
  (``pipeline._upload``: ``torch.from_numpy(...).to(device)`` from
  pageable memory), and beside it the same bytes from a pinned buffer: a
  measurement, not a path of the engine;
* r5b 1b: a sort of 2^25 keys alone, then the same sort with a 12 MB
  ``_upload`` started after it; the upload overlaps the compute by the
  script's rule when both take less than the sort plus 0.6 of the
  upload alone;
* r5e, each twice: the feed alone (``file_batch_feed``); the upload alone
  (one ``_combine``d wire a batch); the fold compute on resident batches
  (``_PipelineRun.fold``'s work a batch, ``fold_windows_into_wide``, at
  2^24 slots); ``count_file`` end to end;
* r5c: ``count_file`` warm, and its result's trim to the host, timed as
  its own phase.

Check: every trimmed table is the same, with 4,999,967 groups and a
total of 130,000,000, and the resident compute finds the same groups;
the feed holds 1,000,000 reads and 130,000,000 windows, the uploaded
wires carry the feed's bases, each r5b upload reads back equal, and the
sort's largest key is the input's.
``small`` counts 1,024 reads (a total of 130 a read), sorts 2^16 keys and
folds into 2^18 slots.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..kernels.wire_keys import wire_keys
from ..ops.wide import WideCounts, fold_windows_into_wide
from ..pipeline import _combine, _upload, count_file, file_batch_feed
from ..runs.ingest import ensure_fastq
from .common import (
    PhaseRecord, card_of, table_digest, twice, wall, workspace)

READS, SEED, K = 1_000_000, 7, 21
SMALL_READS = 1024
WINDOWS_A_READ = 150 - K + 1
FULL = {"groups": 4_999_967, "total": 130_000_000}
FOLD_SLOTS = 1 << 24
SORT_KEYS = 1 << 25  # r5b 1b's sort
UPLOAD_MB = (4, 12, 40)
SITES = {"r5b": "scripts/probe_r5b.py", "r5c": "scripts/probe_r5c.py",
         "r5e": "scripts/probe_r5e.py"}


def ingest_fastq(d: str, small: bool) -> str:
    """The scripts' FASTQ in ``d`` (written unless there): 1,000,000
    reads, or ``SMALL_READS``."""
    n = n_reads(small)
    path = os.path.join(d, f"ingest_{n}.fastq")
    ensure_fastq(path, n, SEED)
    return path


def n_reads(small: bool) -> int:
    """The reads of ``ingest_fastq``'s file."""
    return SMALL_READS if small else READS


def expected(small: bool) -> dict:
    """What a whole count of ``ingest_fastq``'s file holds: its total
    always, its groups at full size."""
    return ({"total": n_reads(small) * WINDOWS_A_READ} if small
            else dict(FULL))


def holds(digest: dict, want: dict) -> bool:
    """Whether a table digest has ``want``'s groups and total."""
    return all(digest[k] == v for k, v in want.items())


def host_batches(path: str) -> tuple[list, int, int, int | None]:
    """``count_file``'s feed drained to a list: (its (words, lengths)
    batches, batch, width, the estimated windows)."""
    it, batch, width, est = file_batch_feed(path, "fastq", K, None, None)
    return list(it), batch, width, est


def fold_compute(wires: list[torch.Tensor], width: int, slots: int
                 ) -> WideCounts:
    """``_PipelineRun.fold``'s work on resident wires: each batch's keys
    (``wire_keys``) folded into one ``slots``-slot accumulator."""
    acc = WideCounts.empty(slots, wires[0].device)
    for wire in wires:
        acc = fold_windows_into_wide(acc, *wire_keys(wire, width, K, True), K)
    return acc


def arrived(got: torch.Tensor, arr: np.ndarray) -> bool:
    """Whether an uploaded tensor holds ``arr``'s words."""
    return bool(torch.equal(got.cpu(), torch.from_numpy(arr.view(np.int32))))


def _uploads(device, card, sort_keys):
    """r5b 1 and 1b; each upload's last copy is read back and compared."""
    rng = np.random.default_rng(0)
    own, pinned = {}, {}
    own_ok = pinned_ok = True
    for mb in UPLOAD_MB:
        arr = rng.integers(0, 1 << 32, (mb << 20) // 4, dtype=np.uint32)
        _upload(arr, device)  # warm the path
        got, own[f"{mb}MB"] = wall(lambda: _upload(arr, device), device)
        own_ok = own_ok and arrived(got, arr)
        host = torch.from_numpy(arr.view(np.int32))
        if device.type == "cuda":
            host = host.pin_memory()
        host.to(device, non_blocking=True)
        got, pinned[f"{mb}MB"] = wall(
            lambda: host.to(device, non_blocking=True), device)
        pinned_ok = pinned_ok and arrived(got, arr)
        del got
    rate = {f"{k} MB/s": round(int(k[:-2]) / s, 1) for k, s in own.items()}
    yield PhaseRecord("r5b 1 upload (pipeline._upload, pageable)",
                      "count_phases", SITES["r5b"], str(device), own_ok, own,
                      rate, card=card)
    yield PhaseRecord(
        "r5b 1 pinned upload (a measurement, not a path of the engine)",
        "count_phases", SITES["r5b"], str(device), pinned_ok, pinned,
        {f"{k} MB/s": round(int(k[:-2]) / s, 1) for k, s in pinned.items()},
        card=card)

    x = torch.from_numpy(rng.integers(0, 1 << 32, sort_keys, dtype=np.int64)
                         ).to(device)

    def heavy():
        return torch.sort(x).values[-1]

    heavy()
    top, compute_s = wall(heavy, device)
    up = rng.integers(0, 1 << 32, (12 << 20) // 4, dtype=np.uint32)
    _upload(up, device)
    (top2, got), both_s = wall(lambda: (heavy(), _upload(up, device)),
                               device)
    overlaps = both_s < compute_s + own["12MB"] * 0.6
    ok = int(top) == int(top2) == int(x.max()) and arrived(got, up)
    yield PhaseRecord(
        "r5b 1b upload during a sort", "count_phases", SITES["r5b"],
        str(device), ok, {"sort": compute_s, "sort+upload": both_s},
        {"keys": x.numel(), "upload_overlaps_compute": bool(overlaps)},
        card=card)


def run(device: torch.device, small: bool = False, workdir=None):
    """Yields the records of r5b, r5e and r5c in that order (the cold
    ``count_file`` first)."""
    card = card_of(device)
    want = expected(small)
    slots = 1 << 18 if small else FOLD_SLOTS
    with workspace(workdir) as d:
        path = ingest_fastq(d, small)

        def count():
            return count_file(path, "fastq", K, canonical=True,
                              device=device)

        res, cold_s = wall(count, device)
        ref = table_digest(res)
        del res
        yield PhaseRecord(
            "r5b 2 count_file cold (its first call here)", "count_phases",
            SITES["r5b"], str(device), holds(ref, want), {"e2e": cold_s},
            {"Mkmers/s": round(ref["total"] / cold_s / 1e6, 2)},
            {"cold": ref}, card=card)
        yield from _uploads(device, card, 1 << 16 if small else SORT_KEYS)

        (host, batch, width, est), feeds = twice(lambda: host_batches(path),
                                                 device)
        lens = np.concatenate([np.asarray(ln, np.int64) for _, ln in host])
        reads, windows = int((lens > 0).sum()), int(
            np.maximum(lens - (K - 1), 0).sum())
        yield PhaseRecord(
            "r5e feed", "count_phases", SITES["r5e"], str(device),
            reads == n_reads(small) and windows == want["total"],
            {"feed": feeds}, {"batch": batch, "width": width,
                              "est_windows": est, "n_batches": len(host),
                              "reads": reads, "windows": windows},
            card=card)
        combos = [_combine(w, ln) for w, ln in host]
        del host
        wires, ups = twice(lambda: [_upload(c, device) for c in combos],
                           device)
        mb = sum(c.nbytes for c in combos) / 1e6
        del combos
        bases = sum(int(w[:, -1].sum()) for w in wires)
        yield PhaseRecord(
            "r5e upload", "count_phases", SITES["r5e"], str(device),
            bases == int(lens.sum()), {"upload": ups},
            {"MB": round(mb, 1), "MB/s": round(mb / min(ups), 1),
             "bases": bases}, card=card)
        table, times = twice(lambda: fold_compute(wires, width, slots),
                             device)
        del wires
        got = table_digest(table)
        del table
        yield PhaseRecord(
            "r5e fold compute (resident batches)", "count_phases",
            SITES["r5e"], str(device), got == ref, {"compute": times},
            {"slots": slots}, {"fold compute": got}, card=card)

        res, times = twice(count, device)
        got = table_digest(res)
        del res
        yield PhaseRecord(
            "r5e count_file", "count_phases", SITES["r5e"], str(device),
            got == ref, {"e2e": times},
            {"Mkmers/s": round(ref["total"] / min(times) / 1e6, 2)},
            {"count_file": got}, card=card)

        res, s = wall(count, device)
        trimmed, trim_s = wall(res.trim, device)
        del res
        got = table_digest(trimmed)
        del trimmed
        yield PhaseRecord(
            "r5c count_file warm", "count_phases", SITES["r5c"], str(device),
            got == ref and holds(got, want),
            {"count_file": s, "trim": trim_s},
            {"Mkmers/s": round(got["total"] / s / 1e6, 2)},
            {"warm": got}, card=card)
