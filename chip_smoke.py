#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``kmer_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits nonzero:

1. device: a CUDA card is required; prints its name and power limit;
2. build: compiles the seven kernel libraries (nvcc) and the host parser
   (cc) from the sources in this checkout, one compiler each at once, and
   prints ptxas's registers and spills (none allowed in the stage, copy,
   gather, wire-key, codes-key and row-sort kernels);
3. kernel vs plain: the segment-count kernel must equal its plain PyTorch
   version exactly on the cases of tests/test_pallas.py, at the edges of
   its tiles (on aligned tensors and on views 8 bytes past 16), and at
   the main path's and a fold batch's shapes (146.8M and 73.4M sorted
   keys), and its closed form above 2^30 slots; times the kernel and
   ``torch.unique_consecutive`` in turns at both shapes, beside the
   bound (12 bytes a slot at the card's published HBM rate); the
   wire-key kernel must equal its plain version in every slot at the
   edges of tests/kernel_edges.py (widths 16 to 161, k 1 to 32,
   canonical or not, with and without the length column, into views 8
   bytes past 16) and at the main path's batch (524,288 rows of width
   160, k = 21, canonical), where it is timed against its byte bound; the
   codes-key kernel likewise at the edges (widths 16 to 170, k 1 to 32,
   codes at byte offsets 0 and 7, one window a row, a row of 69,857
   bases, codes above 3) and at the sustained batch's halo'd rows
   (524,288 x 170, k = 21) and a KmerCounter step (2^17 x 150), and the
   stream-key kernel at the edge streams and at phase 7's stream (1M x
   150 bases) and chr (251,658,240 bases, k = 31) word streams, each
   timed against its byte bound;
4. main path: writes a FASTQ of 1,000,000 x 150 bp reads from a seed and
   counts it (k = 21, canonical) through ``count_file`` on the card; the
   wire-key and segment-count kernels' launch counts must rise, and the
   table must equal an independent numpy oracle exactly;
5. coverage reads and variable-length reads at k = 32 (with all-t reads)
   and k = 31, each exact against the oracle;
6. probes: ``python -m kmer_tpu_torch.probes``'s path (the ported Pallas
   probes at the scripts' shapes, through the four probe kernels) with
   every launch count set to 0 before it; each probe kernel must equal
   its plain version and the scripts' numpy oracles, each count must
   rise; each probe prints its kernel's own time (many calls in one CUDA
   graph, each with its inputs out of the L2 where bytes set the bound),
   its bound and its library call's time, and the gathers' times are
   printed again beside ``torch.gather`` / ``torch.take``; then kernel vs
   plain at edge shapes (tests/kernel_edges.py: gathers at 1 to 4,096
   lanes and tile rows, 1, 3 and 128 steps, tables of 1 and 4,096 words;
   stage loops at 1 to 4,096 lanes and tile rows, empty and overflowing
   schedules; overlapping copies, one copy of one word, a copy that ends
   at the source's last word), and the overlap path's worst case timed:
   32,768 copies of 1,024 words at random destinations, and all at one
   offset;
7. bench: ``run_bench`` (fused and coverage), ``run_bench_stream`` and
   ``run_chr_bench`` on the card, their distinct counts held against
   phases 4 and 5 (and chr against a second route and, at 16M bases, a
   numpy oracle); the wire-key and segment-count kernels' counts must
   rise, the stream-key kernel launch 6 times (the stream and chr modes'
   warm and timed runs) and the codes-key kernel never; the stream and
   chr walls print beside phase 3's stream-key and plain times;
8. the streaming fold of ``count_file``, each case with the wire-key and
   segment-count kernels' counts set to 0 before it and required to
   rise: (a) a sequencing run, 5M x
   150 bp reads at 15x over a 50 Mbp genome (a 1.57 GB FASTQ), growing
   from 2^24 slots, exact against an oracle built from the genome; (b)
   phase 4's file again (~130M live rows, 2^28 slots), equal to phase
   4's table; (c) phase 5's
   file under a 2^19-slot budget with spills to a directory, and a
   checkpointed half run resumed to the end, both equal to phase 5's
   table.  Prints per-batch count, compaction and merge times and the
   peak device memory;
9. the SQL surface on the card (``device="cuda"``): (a) ``run_parity``,
   all 11 checks, with the segment-count kernel's count set to 0 before
   and required to rise; (b) ``run_scale_parity`` at the reference's
   100,000 rows against its pure-Python oracle; (c) the CLI's ``count``
   on a 100,000-row CSV made by its ``datagen``: the kmer column against
   a ``collections.Counter``, and ``--from-dna-column -k 8`` against a
   numpy oracle of the dna strings' 8-mers, with both kernels' counts set
   to 0 before and required to rise; (d) the CLI's ``query`` (one
   ``--eq``, ``--prefix`` and ``--pattern`` each) with and without
   ``--index``, equal outputs;
   (e) ``run_query_bench`` at 2^22 keys (every query found by
   hash and by binary search, the same rows both ways) and (f)
   ``run_pattern_bench`` at 2^22 keys, each timed with its peak device
   memory;
10. the rest of the one-device engine, each case with the count path's
   launch counts set to 0 just before it and read just after: (a)
   ``KmerCounter`` (k = 21, canonical) over phase 4's reads in 8 steps of
   2^17 reads, merged exactly, equal to phase 4's table, 8 codes-key and
   8 segment-count launches; (b) the dense route, ``KmerCounter`` at k =
   6 and ``count_kmers_auto`` at k = 8, each equal to the sort route's
   table at its k, 9 codes-key launches and no segment-count launch, and
   both routes timed at k = 4, 6, 8, 10; (c) the graft entry on the card,
   equal to its CPU result, one codes-key launch; (d)
   ``count_long_sequence`` over the chr sequence of phase 7 (251,658,240
   bases, k = 31, canonical, chunks of 2^24), its distinct count equal to
   phase 7's, then a resumable run over its first 2^25 bases checkpointed
   after half its chunks, resumed in a new ``ResumableCount`` and equal
   to the fast path; (e) ``count_read_stream`` over phase 4's reads in
   batches of 2^17, equal to phase 4's table, and its first 3 batches
   under a 2^25-slot budget with spills to a directory, equal to (a)'s
   table after 3 steps; (f) ``serve`` on the card: a 250,000-row
   ``datagen`` CSV loaded and indexed, 1,000 mixed EQ/PREFIX/PATTERN
   queries timed (p50/p99) and each equal to the table's scan on the
   card; then at phase 9's 100,000 rows a ``--wal`` server killed with -9
   after its acks and restarted with ``--tcp``, whose 4 concurrent
   clients must answer as the killed server's stdin did; (g) ``python -m
   kmer_tpu_torch selftest --device cuda``;
11. multi-device on the card, each case with the count path's launch
   counts set to 0 before it (in every rank) and read after: (a)
   ``python -m kmer_tpu_torch distcount --backend nccl`` as one rank over
   phase 4's FASTQ, its rank file equal to phase 4's table; then
   DISTCOUNT_r05.json's durability case (1M x 150 bp reads of a 5 Mbp
   genome, batches of 65,536 reads, a checkpoint every 4): a straight run
   equal to the genome oracle, and a run killed with -9 once its first
   checkpoint is on disk and resumed, its rank file equal to the straight
   run's bit for bit; (b) 4 ``distcount`` ranks on the
   gloo backend sharing the card, mesh (4,1), over 8a's reads split into
   4 record-aligned shards, every rank launching both kernels, and
   ``merge_rank_files`` of their files equal to 8a's genome oracle; each
   rank's wall, k-mers/s, peak memory and merge efficiency printed (every
   distcount rank fed the wire: no codes-key launch); (c)
   ``count_kmers_sharded`` at (2,2) over 4 gloo ranks (a
   ``parallel.launch.World``), both merges and a forced overflow, each
   rank's table equal to the one-device count (its hash range of it for
   the partition), every rank launching the codes-key kernel; (d)
   ``KmerCounter.count_sharded`` there, and ``dryrun_multichip(4)`` on
   the card, every rank launching the codes-key kernel too; (e)
   ``run_sharded_query_bench`` (``bench --mode shq``) over the 4 ranks at
   2^22 keys, its counts
   equal to a one-device ``DeviceIndex``'s.  The collectives that gloo
   staged through host memory are printed;
12. the long runs, each in child processes that print their kernel
   launches: (a) ``python -m kmer_tpu_torch.bench_entry`` with
   ``KMER_BENCH_MODE=fused`` prints one JSON line on stdout and its
   ``detail`` on stderr, its counts equal to phase 7's in-process run at
   the same defaults, and both count-path kernels launched; (b) the
   sustained stream (``runs.sustained``) at full size: 151 batches of
   524,288 x 150 bp reads of a 1 Mbp genome, straight here, then killed
   after 56 batches and resumed in children; the resumed table equals the
   straight one bit for bit and a numpy oracle, with 999,980 groups, the
   resume starts at batch >= 16, and the codes-key and segment-count
   kernels launch once a batch (and once to warm up), ``wire_keys`` never
   (raw codes), in the straight run and in each child;
   (c) ``runs.ingest`` on 8a's FASTQ: the CLI ``count --chunk-mb 128
   --top 3`` in a child whose peak RSS, less the shared libraries'
   resident pages of an idle child (one that imports torch and starts
   the card), stays under 4 GB (the raw peak is printed beside it), its
   groups, total and top rows equal to 8a's oracle; then the CLI's
   ``count --ckpt`` straight (its final checkpoint equal to the oracle), a ``count_file`` child
   checkpointing every sixth of that count's seconds, killed with
   SIGKILL once two checkpoints have landed, and resumed: it skips at
   least one batch and its table equals the straight one;
13. the sort probes and the sample-partition engine, each family with
   the launch counts of ``row_sort``, ``segment_copy``, ``segment_counts``
   and ``wire_keys`` set to 0 before it and read after: (a) the
   ``sorting`` family at full size (the global and row sorts of
   probe_sort.py, probe_r2.py C, probe_r3a.py A-D and probe_r3b.py 3 on
   ``row_sort`` where a row fits, beside ``torch.sort(dim=1)``, or on
   ``torch.sort`` alone; searchsorted; the block gathers on
   ``segment_copy``; the per-row counts; the monotone gather); (b) the
   ``partition`` family: probe_r3c.py's engines A and B and the port's C
   (stage 1 on ``row_sort``) on its uniform and coverage lanes at N =
   136,314,880 (made by ``stream_keys``), each trimmed table and r3c's
   four scalars equal to ``count_windows`` on the same keys, ``row_sort``,
   ``segment_copy``, ``segment_counts`` and ``stream_keys`` all launched;
   (c) ``row_sort`` equal to its plain
   version at config C's stage-1 rows, [8320, 16384] int64, and timed
   there in a CUDA graph (cold L2) beside ``torch.sort(dim=1)`` and its
   byte bound.  ptxas must report no spill in ``row_sort.cu`` (phase 2);
14. the phase probes (``python -m kmer_tpu_torch.probes``' phase
   families at their scripts' workloads), each family with the count
   path's kernels' counts set to 0 before it and read after, each
   required to rise where ``probes.PHASE_KERNELS`` lists it (the codes-key
   kernel in ``fold_step`` and ``stream_loop``): ``feed`` (a 1,035 MB
   FASTQ of 3.3M reads, the native parser and the file feed at batch 4,096
   and 65,536), ``device_phases`` (2^20 reads: extraction, sort and
   segment counts alone, three primitive rates), ``count_phases``
   (``count_file`` on the 313 MB FASTQ of ``runs.ingest.write_fastq(...,
   1_000_000, seed=7)``: uploads pageable and pinned, an upload during a
   sort, the feed, upload and the fold's compute on resident batches,
   ``count_file`` warm, the trim; every table 4,999,967 groups and
   130,000,000 k-mers), ``read_stream`` (``count_read_stream`` split up, and a
   pipelined fold equal to it), ``fold_step`` (the sustained step's parts
   and the merge cadence, equal to the per-batch fold; the extraction
   from the wire, by ``codes_keys`` and by its plain version, the last
   two equal), ``stream_loop``
   (151 steps free-running and with checkpoint writes, and batches of
   512k, 1M and 2M reads), ``checkpoint`` (one write of a 4M-slot
   accumulator split up; every file reloads to its rows) and
   ``distcount_step`` (the distcount step on one NCCL rank, equal to
   ``count_file``, and on two gloo ranks sharing the card, with the staged
   all_to_all's legs); then the ``matmul`` rates (the int8 permute exact,
   the bf16 product within a relative 1e-2).  Every probe must be
   correct; the records print as one JSON line; the phase's time prints
   beside its budget.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it is the card's name and power limit, and the one before that the
kernels' JSON record.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
MAIN_READS, READ_LEN, K = 1_000_000, 150, 21


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --- data and the numpy oracle -------------------------------------------


LETTERS = np.frombuffer(b"ACGT", np.uint8)


def fastq_records(reads: np.ndarray, first: int = 0) -> bytes:
    """FASTQ records of fixed-length 2-bit code reads [n, L], named
    ``r<7 digits>`` from ``first`` on."""
    n, length = reads.shape
    head = 9  # "@r" + 7 digits
    rec = np.empty((n, head + 1 + length + 3 + length + 1), np.uint8)
    rec[:, 0], rec[:, 1] = ord("@"), ord("r")
    idx = np.arange(first, first + n)
    for d in range(7):
        rec[:, 2 + d] = ord("0") + (idx // 10 ** (6 - d)) % 10
    rec[:, head] = ord("\n")
    rec[:, head + 1: head + 1 + length] = LETTERS[reads]
    q = head + 1 + length
    rec[:, q: q + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, q + 3: q + 3 + length] = ord("I")
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def write_fastq(path: str, reads: list[np.ndarray] | np.ndarray) -> None:
    """FASTQ of 2-bit code reads; fixed-length reads are written in bulk."""
    with open(path, "wb") as f:
        if isinstance(reads, np.ndarray):
            f.write(fastq_records(reads))
            return
        for i, r in enumerate(reads):
            seq = LETTERS[r].tobytes()
            f.write(b"@v%d\n%s\n+\n%s\n" % (i, seq, b"I" * len(r)))


def oracle_keys(reads: np.ndarray, k: int, canonical: bool) -> np.ndarray:
    """Window keys of fixed-length reads [n, L] as uint64, with numpy:
    the reverse complement comes from the reverse-complemented read."""
    n, length = reads.shape
    m = length - k + 1
    if m <= 0:
        return np.zeros(0, np.uint64)

    def windows(codes):
        out = np.zeros((codes.shape[0], m), np.uint64)
        for j in range(k):
            out |= codes[:, j: j + m].astype(np.uint64) << np.uint64(62 - 2 * j)
        return out

    out = np.empty(n * m, np.uint64)
    step = 65536
    for s in range(0, n, step):
        part = reads[s: s + step]
        keys = windows(part)
        if canonical:
            rc = windows(3 - part[:, ::-1])[:, ::-1]
            keys = np.minimum(keys, rc)
        out[s * m: (s + part.shape[0]) * m] = keys.reshape(-1)
    return out


def check_table(table, keys: np.ndarray, k: int, what: str) -> None:
    """The port's table must equal np.unique over the oracle's keys."""
    from kmer_tpu_torch.packed import key_from_hi_lo

    want, want_counts = np.unique(keys, return_counts=True)
    t = table.trim()
    hi, lo, length, _, _ = t.to_numpy()
    got = key_from_hi_lo(hi, lo).view(np.uint64)
    check(np.array_equal(got, want), f"{what}: keys equal the oracle's")
    check(np.array_equal(t.counts64(), want_counts), f"{what}: counts equal")
    check(bool((length == k).all()), f"{what}: every length is k")
    check(table.distinct() == want.size, f"{what}: n_unique")


# --- phases --------------------------------------------------------------


def load_by_path(path: str):
    """The module in the file at ``path``, imported without putting its
    directory on ``sys.path``."""
    import importlib.util

    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ptxas_report(stem: str) -> str:
    """ptxas's registers, spills and shared memory for each kernel of
    ``csrc/<stem>.cu``, from the log of its build."""
    from kmer_tpu_torch.kernels.build import BUILD_DIR

    with open(os.path.join(BUILD_DIR, f"lib{stem}.so.log")) as f:
        return "; ".join(ln.split(":", 1)[-1].strip() for ln in f
                         if "Used" in ln or "spill" in ln)


def check_no_spills(stem: str) -> None:
    """ptxas must report 0 spill bytes for every kernel of ``stem``."""
    import re

    from kmer_tpu_torch.kernels.build import BUILD_DIR

    with open(os.path.join(BUILD_DIR, f"lib{stem}.so.log")) as f:
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill", f.read())]
    check(bool(spills) and not any(spills), f"ptxas: no spills in {stem}.cu")


def time_cuda(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def count_path_kernels() -> dict:
    from kmer_tpu_torch.kernels import count_path_kernels

    return count_path_kernels()


def zero_launches() -> None:
    from kmer_tpu_torch.kernels import zero_launches

    zero_launches()


# the codes- and stream-fed kernels on a path fed the packed wire (or no
# reads at all): never launched
WIRE_FED = {"codes_keys": 0, "stream_keys": 0}


def check_launches(what: str, launches: dict, want: dict | None = None
                   ) -> dict:
    """Each count-path kernel's launches in ``launches`` must be its
    ``want`` (an int, or a (low, high) range), by default at least 1."""
    for name, n in launches.items():
        w = (want or {}).get(name, (1, float("inf")))
        lo, hi = w if isinstance(w, tuple) else (w, w)
        check(lo <= n <= hi, f"{what}: {n} {name} launches, expected {w}")
    return launches


def read_launches(what: str, want: dict | None = None) -> dict:
    """The count path's kernels' launches since ``zero_launches``, checked
    against ``want`` (``check_launches``)."""
    from kmer_tpu_torch.kernels import launches as read

    return check_launches(what, read(), want)


# the kernel's timed shapes: (slots, sentinel slots) of phase 4's file in
# one sort (2 batches x 524,288 rows x 140 slots) and of one fold batch
TIMED_SHAPES = {"main path": (2 * 524288 * 140, 2 * 524288 * 16),
                "fold batch": (524288 * 140, 524288 * 16)}
ABOVE_2_30 = (1 << 30) + 12345  # slots of the closed-form case


def kernel_cases(dev) -> dict:
    """Kernel == plain version, exactly, on every case; kernel vs
    ``torch.unique_consecutive`` in turns at the main path's and a fold
    batch's shape, beside the bound."""
    import torch

    from kmer_tpu_torch.kernels.segment_counts import (
        segment_counts, segment_counts_reference, segment_counts_tile)
    from kmer_tpu_torch.ops.count import SENTINEL_KEY
    from kmer_tpu_torch.packed import SIGN_FLIP, as_int64, key_from_hi_lo
    from kmer_tpu_torch.probes.common import bound_ms

    edges = load_by_path(os.path.join(ROOT, "tests", "kernel_edges.py"))

    def compare(keys, sentinel, what):
        kc, ku = segment_counts(keys, sentinel)
        pc, pu = segment_counts_reference(keys, sentinel)
        torch.cuda.synchronize()
        err = int((kc.to(torch.int64) - pc.to(torch.int64)).abs().max()) \
            if keys.numel() else 0
        check(torch.equal(kc, pc) and int(ku) == int(pu),
              f"kernel == plain on {what} (max |diff| {err}, n_unique "
              f"{int(ku)} vs {int(pu)})")
        log(f"kernel == plain: {what}: n={keys.numel()} "
            f"n_unique={int(ku)} max_abs_err={err}")
        return err

    def sorted_pairs(hi, lo):
        order = np.lexsort((lo, hi))
        keys = key_from_hi_lo(hi[order].astype(np.uint32),
                              lo[order].astype(np.uint32))
        return torch.from_numpy(keys.copy()).to(dev)

    t = segment_counts_tile()
    rng = np.random.default_rng(SEED)
    u32 = np.uint32
    cases = [
        ("random with duplicates",
         rng.integers(0, 7, 5000).astype(u32),
         rng.integers(0, 5, 5000).astype(u32), None),
        ("one segment spanning every tile",
         np.r_[np.zeros(5 * t + 7, u32), u32(9)],
         np.zeros(5 * t + 8, u32), None),
        ("tile-aligned n (2048)", rng.integers(0, 3, 2048).astype(u32),
         np.zeros(2048, u32), None),
        ("tile-aligned n (8192)", rng.integers(0, 3, 8192).astype(u32),
         np.zeros(8192, u32), None),
        ("all unique", np.arange(1500, dtype=u32),
         np.arange(1500, dtype=u32), None),
    ]
    hi = rng.integers(0, 5, 3000).astype(u32)
    lo = rng.integers(0, 3, 3000).astype(u32)
    hi[:700], lo[:700] = 0xFFFFFFFF, 0xFFFF0000
    cases.append(("sentinel folding", hi, lo, (0xFFFFFFFF, 0xFFFF0000)))
    cases.append(("n = 1", np.array([5], u32), np.array([0], u32), None))
    cases.append(("n = 2", np.array([5, 5], u32), np.array([0, 1], u32),
                  None))
    for what, hi, lo, sent in cases:
        sentinel = None if sent is None else as_int64(
            (sent[0] << 32) | sent[1])
        compare(sorted_pairs(hi, lo), sentinel, what)
    compare(torch.zeros(0, dtype=torch.int64, device=dev), None, "n = 0")

    # the tile edges (tests/kernel_edges.py: run i holds key i, then a
    # sentinel run), on an aligned tensor and on a view 8 bytes past one
    for what in edges.EDGES + edges.LARGE:
        lengths, sentinel_run = edges.edge_runs(what, t)
        sentinel = 1 << 62 if sentinel_run else None
        host = np.r_[np.repeat(np.arange(lengths.size), lengths),
                     np.full(sentinel_run, 1 << 62)]
        buf = torch.empty(host.size + 1, dtype=torch.int64, device=dev)
        for view, where in ((buf[:-1], "16-byte aligned"),
                            (buf[1:], "8 bytes past 16")):
            view.copy_(torch.from_numpy(host))
            compare(view, sentinel, f"{what} (T = {t}), {where}")

    # above 2^30 slots, against the closed form
    n = ABOVE_2_30
    keys = torch.arange(n, dtype=torch.int64, device=dev) >> 10
    counts, n_unique = segment_counts(keys)
    del keys
    full = n // 1024 * 1024
    blocks = counts[:full].view(-1, 1024)
    check(bool((blocks[:, :1023] == 0).all())
          and bool((blocks[:, 1023] == 1024).all())
          and bool((counts[full:-1] == 0).all())
          and int(counts[-1]) == n - full
          and int(n_unique) == -(-n // 1024),
          f"kernel == closed form of arange({n}) >> 10")
    log(f"kernel == closed form: n={n} (above 2^30) n_unique={int(n_unique)}")
    del counts, blocks

    # left-aligned 21-mers drawn from 2^27 values (segments of 1 to ~10
    # equal keys), the padding slots set to the sentinel, sorted
    timing = {}
    sentinel = SENTINEL_KEY ^ SIGN_FLIP
    for shape, (n, n_sent) in TIMED_SHAPES.items():
        keys = rng.integers(0, 1 << 27, n, dtype=np.int64) << 22
        keys[-n_sent:] = SENTINEL_KEY
        skeys = torch.sort(torch.from_numpy(keys).to(dev) ^ SIGN_FLIP).values
        del keys
        err = compare(skeys, sentinel, f"{shape} shape")
        turns = []
        for _ in range(2):  # kernel, library call, kernel, library call
            turns.append(time_cuda(lambda: segment_counts(skeys, sentinel),
                                   20))
            turns.append(time_cuda(lambda: torch.unique_consecutive(
                skeys, return_counts=True), 20))
        plain_ms = time_cuda(
            lambda: segment_counts_reference(skeys, sentinel), 3)
        # 8 B read and 4 B written a slot; 64-bit compares with both
        # neighbours and the sentinel (2 int32 operations each), a subtract
        bound, by = bound_ms(12 * n + 4, 7 * n, dev)
        ms, lib_ms = (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2
        timing[shape] = {"n": n, "max_abs_err": float(err), "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": by, "library_ms": lib_ms,
                         "pct_of_bound": 100 * bound / ms}
        log(f"{shape} shape n={n}: kernel {turns[0]:.4f} / {turns[2]:.4f} "
            f"ms, torch.unique_consecutive {turns[1]:.4f} / {turns[3]:.4f} "
            f"ms (in turns, 20 launches each), plain {plain_ms:.4f} ms; "
            f"bound {bound:.4f} ms ({by}), kernel at "
            f"{100 * bound / ms:.2f}% of it")
        del skeys
    return timing


def halves_err(a, b) -> int:
    """max |difference| of int64 keys' unsigned 32-bit halves"""
    if a.numel() == 0:
        return 0
    return max(int(((a >> s & 0xFFFFFFFF) - (b >> s & 0xFFFFFFFF))
                   .abs().max()) for s in (32, 0))


# the main path's batch: 524,288 rows of width 160 (10 base words and the
# length column), k = 21, canonical: 140 window slots a row
WIRE_ROWS, WIRE_WIDTH = 524288, 160
# int32 operations a canonical window costs, about: the three-word read's
# indices and bounds, the 64-bit shifts, ors and mask as int32 pairs
# (~14), the reverse complement (not, brev, the pair swap, the shift:
# ~14), the unsigned minimum (~4), the valid compare (~4)
WIRE_OPS = 36


def wire_key_cases(dev) -> dict:
    """The wire-key kernel == its plain version in every slot at the edges
    of tests/kernel_edges.py and at the main path's batch shape, timed
    there against its bound; returns the kernels-line fields."""
    import torch

    from kmer_tpu_torch.kernels.wire_keys import wire_keys, wire_keys_reference
    from kmer_tpu_torch.native import pack2bit_rows
    from kmer_tpu_torch.probes.common import bound_ms

    edges = load_by_path(os.path.join(ROOT, "tests", "kernel_edges.py"))

    def wire_of(words, lengths):
        if lengths is not None:
            words = np.concatenate([words, lengths[:, None]], axis=1)
        words = np.ascontiguousarray(words, np.uint32).view(np.int32)
        return torch.from_numpy(words).to(dev)

    def compare(wire, width, k, canonical, lengths, what, view_lead=None):
        m = width - k + 1
        out = None
        if view_lead is not None:  # a view 8 * lead bytes past 16
            flat = torch.empty(wire.shape[0] * m + 1, dtype=torch.int64,
                               device=dev)
            out = flat[view_lead: view_lead + wire.shape[0] * m].view(-1, m)
        got, valid = wire_keys(wire, width, k, canonical, lengths=lengths,
                               keys_out=out)
        want, want_valid = wire_keys_reference(wire, width, k, canonical,
                                               lengths=lengths)
        torch.cuda.synchronize()
        err = halves_err(got, want)
        check(torch.equal(got, want) and (valid is None) == (not lengths)
              and (not lengths or torch.equal(valid, want_valid)),
              f"wire_keys == plain on {what} (max |diff| of a half {err})")
        return err

    errs, n_cases = [], 0
    for width in edges.WIRE_WIDTHS:
        for k in (k for k in edges.WIRE_KS if k <= width):
            codes, lengths = edges.wire_case(width, k, rows=300)
            words = pack2bit_rows(codes)
            for canonical in (False, True):
                for lens in (lengths, None):
                    for lead in (None, 1):
                        errs.append(compare(
                            wire_of(words, lens), width, k, canonical,
                            lens is not None, f"width {width} k {k}", lead))
                        n_cases += 1
    log(f"wire_keys == plain at the edge shapes ({n_cases} cases: widths "
        f"{edges.WIRE_WIDTHS} x k {edges.WIRE_KS} x canonical x length "
        "column x aligned / 8 bytes past 16)")

    rng = np.random.default_rng(SEED + 3)
    nw = WIRE_WIDTH // 16
    words = rng.integers(0, 1 << 32, (WIRE_ROWS, nw), dtype=np.uint64)
    lengths = rng.integers(0, WIRE_WIDTH + 1, WIRE_ROWS).astype(np.uint32)
    lengths[::2] = READ_LEN  # the main path's reads
    wire = wire_of(words.astype(np.uint32), lengths)
    del words
    slots = WIRE_ROWS * (WIRE_WIDTH - K + 1)
    what = f"the main path's batch ({WIRE_ROWS} x width {WIRE_WIDTH})"
    errs.append(compare(wire, WIRE_WIDTH, K, True, True, what))
    errs.append(compare(wire, WIRE_WIDTH, K, True, True, what + ", a view",
                        view_lead=1))
    turns = [time_cuda(lambda: wire_keys(wire, WIRE_WIDTH, K, True), 20)
             for _ in range(2)]
    plain_ms = time_cuda(
        lambda: wire_keys_reference(wire, WIRE_WIDTH, K, True), 3)
    # the wire read once, 8 bytes of key and 1 of valid written a slot
    bound, by = bound_ms(wire.numel() * 4 + 9 * slots, WIRE_OPS * slots, dev)
    ms = sum(turns) / 2
    log(f"wire_keys at {what}, k = {K}, canonical: {slots} slots, exact; "
        f"kernel {turns[0]:.4f} / {turns[1]:.4f} ms (20 launches each), "
        f"plain {plain_ms:.4f} ms; bound {bound:.4f} ms ({by}), kernel at "
        f"{100 * bound / ms:.2f}% of it")
    return {"slots": slots, "max_abs_err": float(max(errs)), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "pct_of_bound": 100 * bound / ms}


# codes_keys' timed shapes: (rows, codes a row, k): the sustained batch's
# halo'd rows through _extract_with_halo (150 windows a row) and a
# KmerCounter step of 2^17 reads (130 windows a row)
CODES_TIMED = {"sustained batch": (524288, 170, 21),
               "KmerCounter step": (1 << 17, READ_LEN, 21)}
# stream_keys' timed streams: (reads, read length, k), phase 7's: the
# bench's stream mode over phase 4's reads and the chr mode's sequence
STREAM_TIMED = {"bench stream": (MAIN_READS, READ_LEN, K),
                "chr": (1, 15 << 24, 31)}


def timed_against_bound(kernel, plain, nbytes: int, ops: int, dev,
                        what: str, slots: int) -> dict:
    """A keys kernel in turns (20 launches each) and its plain version,
    beside the bound of its bytes and int32 operations."""
    from kmer_tpu_torch.probes.common import bound_ms

    turns = [time_cuda(kernel, 20) for _ in range(2)]
    plain_ms = time_cuda(plain, 3)
    bound, by = bound_ms(nbytes, ops, dev)
    ms = sum(turns) / 2
    log(f"{what}: {slots} slots, exact; kernel {turns[0]:.4f} / "
        f"{turns[1]:.4f} ms (20 launches each), plain {plain_ms:.4f} ms; "
        f"bound {bound:.4f} ms ({by}), kernel at {100 * bound / ms:.2f}% of "
        "it")
    return {"slots": slots, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "pct_of_bound": 100 * bound / ms}


def codes_key_cases(dev) -> dict:
    """The codes-key kernel == its plain version in every slot at the edges
    of tests/kernel_edges.py and at its timed shapes, timed there against
    its bound; returns the kernels-line fields."""
    import torch

    from kmer_tpu_torch.kernels.codes_keys import (
        codes_keys, codes_keys_reference)

    edges = load_by_path(os.path.join(ROOT, "tests", "kernel_edges.py"))

    def on_card(codes, offset):
        buf = torch.zeros(codes.size + 32, dtype=torch.uint8, device=dev)
        view = buf[offset: offset + codes.size].view(codes.shape)
        return view.copy_(torch.from_numpy(codes))

    def compare(codes, lengths, k, canonical, what, view_lead=None):
        m = codes.shape[1] - k + 1
        out = None
        if view_lead is not None:  # a view 8 * lead bytes past 16
            flat = torch.empty(codes.shape[0] * m + 1, dtype=torch.int64,
                               device=dev)
            out = flat[view_lead: view_lead + codes.shape[0] * m].view(-1, m)
        got, valid = codes_keys(codes, lengths, k, canonical, keys_out=out)
        want, want_valid = codes_keys_reference(codes, lengths, k, canonical)
        torch.cuda.synchronize()
        err = halves_err(got, want)
        check(torch.equal(got, want) and torch.equal(valid, want_valid),
              f"codes_keys == plain on {what} (max |diff| of a half {err})")
        return err

    errs, n_cases = [], 0
    for width in edges.CODES_WIDTHS:
        for k in (k for k in edges.CODES_KS if k <= width):
            codes, lengths = edges.codes_case(width, k, rows=300)
            lens = torch.from_numpy(lengths).to(dev)
            for canonical in (False, True):
                for offset, lead in ((0, None), (7, 1)):
                    errs.append(compare(on_card(codes, offset), lens, k,
                                        canonical, f"width {width} k {k}",
                                        lead))
                    n_cases += 1
    for name, *_ in edges.CODES_SHAPES:
        codes, lengths, k = edges.codes_shape(name)
        for offset in (0, 3):
            errs.append(compare(on_card(codes, offset),
                                torch.from_numpy(lengths).to(dev), k, True,
                                name, 1))
            n_cases += 1
    codes, lengths = edges.wide_codes(150, 21, rows=300)
    for canonical in (False, True):
        errs.append(compare(on_card(codes, 5),
                            torch.from_numpy(lengths).to(dev), 21,
                            canonical, "codes above 3"))
        n_cases += 1
    log(f"codes_keys == plain at the edge shapes ({n_cases} cases: widths "
        f"{edges.CODES_WIDTHS} x k {edges.CODES_KS} x canonical x codes at "
        f"byte 0 / 7, aligned / 8 bytes past 16; "
        f"{[c[0] for c in edges.CODES_SHAPES]}; codes above 3)")

    rng = np.random.default_rng(SEED + 4)
    timing = {}
    for shape, (rows, width, k) in CODES_TIMED.items():
        codes = torch.from_numpy(rng.integers(0, 4, (rows, width),
                                              dtype=np.uint8)).to(dev)
        lengths = torch.full((rows,), READ_LEN, dtype=torch.int32,
                             device=dev)
        slots = rows * (width - k + 1)
        what = f"codes_keys at the {shape} ({rows} x {width}, k = {k})"
        errs.append(compare(codes, lengths, k, True, what))
        errs.append(compare(codes, lengths, k, True, what + ", a view", 1))
        # the codes and lengths read once, 8 bytes of key and 1 of valid
        # written a slot; WIRE_OPS int32 operations a window
        timing[shape] = timed_against_bound(
            lambda: codes_keys(codes, lengths, k, True),
            lambda: codes_keys_reference(codes, lengths, k, True),
            codes.numel() + 4 * rows + 9 * slots, WIRE_OPS * slots, dev,
            what, slots)
        del codes, lengths
    torch.cuda.empty_cache()
    return {**timing["sustained batch"], "max_abs_err": float(max(errs)),
            "at_kmer_counter_step": timing["KmerCounter step"]}


def stream_key_cases(dev) -> dict:
    """The stream-key kernel == its plain version in every slot at the
    edges of tests/kernel_edges.py and at the bench's stream and chr
    streams, timed there against its bound; returns the kernels-line
    fields."""
    import torch

    from kmer_tpu_torch.kernels.wire_keys import (
        stream_keys, stream_keys_reference)
    from kmer_tpu_torch.native import pack2bit_rows

    edges = load_by_path(os.path.join(ROOT, "tests", "kernel_edges.py"))

    def compare(words, k, canonical, read_len, n_reads, what):
        got, valid = stream_keys(words, k, canonical, read_len, n_reads)
        want, want_valid = stream_keys_reference(words, k, canonical,
                                                 read_len, n_reads)
        torch.cuda.synchronize()
        err = halves_err(got, want)
        check(torch.equal(got, want) and torch.equal(valid, want_valid),
              f"stream_keys == plain on {what} (max |diff| of a half {err})")
        return err

    errs, n_cases = [], 0
    for n_reads, read_len in edges.STREAM_CASES:
        words = pack2bit_rows(edges.stream_case(n_reads, read_len)[None, :])[0]
        buf = torch.zeros(words.size + 1, dtype=torch.int32, device=dev)
        for at, view in (("aligned", buf[:-1]), ("4 bytes past", buf[1:])):
            view.copy_(torch.from_numpy(words.view(np.int32)))
            for k in edges.STREAM_KS:
                for canonical in (False, True):
                    errs.append(compare(view, k, canonical, read_len,
                                        n_reads, f"{n_reads} x {read_len} "
                                        f"k {k} ({at})"))
                    n_cases += 1
    log(f"stream_keys == plain at the edge streams ({n_cases} cases: "
        f"{edges.STREAM_CASES} x k {edges.STREAM_KS} x canonical x words "
        "aligned / 4 bytes past 16)")

    # random words of the modes' sizes: the kernel's work does not depend
    # on the bases, and drawing words skips packing 252M codes on the host
    rng = np.random.default_rng(SEED + 5)
    timing = {}
    for shape, (n_reads, read_len, k) in STREAM_TIMED.items():
        words = torch.from_numpy(rng.integers(
            0, 1 << 32, n_reads * read_len // 16, dtype=np.uint64
        ).astype(np.uint32).view(np.int32)).to(dev)
        slots = 16 * words.numel()
        what = (f"stream_keys at the {shape} ({n_reads} x {read_len} bases, "
                f"k = {k})")
        errs.append(compare(words, k, True, read_len, n_reads, what))
        # the words read once, 8 bytes of key and 1 of valid written a
        # slot; WIRE_OPS int32 operations a window
        timing[shape] = timed_against_bound(
            lambda: stream_keys(words, k, True, read_len, n_reads),
            lambda: stream_keys_reference(words, k, True, read_len, n_reads),
            4 * words.numel() + 9 * slots, WIRE_OPS * slots, dev, what,
            slots)
        del words
        torch.cuda.empty_cache()
    return {**timing["chr"], "max_abs_err": float(max(errs)),
            "at_bench_stream": timing["bench stream"]}

def main_path(dev, tmp: str):
    """Counts the 1M x 150 bp FASTQ on the card; returns (the kernels'
    launches, the FASTQ's path, its oracle-checked host table)."""
    import torch

    from kmer_tpu_torch.ops.extract import simulate_reads
    from kmer_tpu_torch.pipeline import count_file

    reads = simulate_reads(MAIN_READS, READ_LEN, seed=SEED)
    path = os.path.join(tmp, "reads.fastq")
    t0 = time.perf_counter()
    write_fastq(path, reads)
    log(f"main path: wrote {os.path.getsize(path)} bytes of FASTQ in "
        f"{time.perf_counter() - t0:.3f} s")

    windows = MAIN_READS * (READ_LEN - K + 1)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    table = count_file(path, "fastq", K, canonical=True, device=dev)
    torch.cuda.synchronize(dev)
    t_count = time.perf_counter() - t0
    launches = read_launches("the main path", WIRE_FED)
    host = table.trim()
    wall = time.perf_counter() - t0
    log(f"main path: count_file {t_count:.3f} s, with trim to host "
        f"{wall:.3f} s = {windows / wall:.1f} k-mers/s; kernel launches "
        f"{launches}; slots {table.capacity}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev)} bytes")
    del table

    t0 = time.perf_counter()
    keys = oracle_keys(reads, K, canonical=True)
    check_table(host, keys, K, "main path")
    log(f"main path: exact against the numpy oracle ({time.perf_counter() - t0:.1f} s); "
        f"distinct {host.distinct()}, total {host.total()}")

    t0 = time.perf_counter()
    count_file(path, "fastq", K, canonical=True, device=dev).trim()
    wall = time.perf_counter() - t0
    log(f"main path, second run: {wall:.3f} s = {windows / wall:.1f} "
        "k-mers/s")
    return launches, path, host


def edge_cases(dev, tmp: str):
    """Coverage and variable-length reads; returns the coverage FASTQ's
    path and its oracle-checked host table."""
    from kmer_tpu_torch.ops.extract import simulate_coverage_reads
    from kmer_tpu_torch.pipeline import count_file

    reads = simulate_coverage_reads(200_000, READ_LEN, 1_000_000, seed=SEED)
    cov_path = os.path.join(tmp, "coverage.fastq")
    write_fastq(cov_path, reads)
    table = count_file(cov_path, "fastq", K, canonical=True, device=dev)
    check_table(table, oracle_keys(reads, K, canonical=True), K, "coverage")
    log(f"coverage reads: exact; distinct {table.distinct()}, total "
        f"{table.total()}")
    coverage = table.trim()

    rng = np.random.default_rng(SEED + 1)
    var = [rng.integers(0, 4, int(n), dtype=np.uint8)
           for n in rng.integers(1, 400, 40_000)]
    for i in range(0, len(var), 40):
        var[i][:] = 3  # all-t reads: at k = 32 their key is all ones
    path = os.path.join(tmp, "varlen.fastq")
    write_fastq(path, var)
    for k, canonical, width in ((32, False, 160), (31, True, None)):
        keys = np.concatenate(
            [oracle_keys(r[None, :], k, canonical) for r in var])
        table = count_file(path, "fastq", k, canonical=canonical,
                           width=width, device=dev)
        check_table(table, keys, k, f"variable-length reads, k={k}")
        log(f"variable-length reads, k={k} canonical={canonical} "
            f"width={width or 'auto'}: exact; distinct {table.distinct()}, "
            f"total {table.total()}")
    return cov_path, coverage


# the probe kernels: the probe whose times stand for each in the kernels
# line, and the rows of scripts/ it replaces
PROBE_KERNELS = {
    "tile_gather": ("gather_lanes(amplified)",
                    "scripts/probe_pallas.py:34; scripts/probe_pallas2.py:26;"
                    " scripts/probe_pallas3.py:55, 70, 86"),
    "tile_stages": ("cmpex1_roll_lanes(amplified)",
                    "scripts/probe_pallas.py:34, 113; "
                    "scripts/probe_pallas2.py:26, 89, 143; "
                    "scripts/probe_pallas3.py:32, 86; "
                    "scripts/probe_r2.py:150, 164"),
    "row_sort": ("inkernel_sort_lanes(random)", "scripts/probe_pallas2.py:26"),
    "segment_copy": ("F_dma_G32768_SEG1024",
                     "scripts/probe_pallas2.py:179; "
                     "scripts/probe_pallas3.py:151; scripts/probe_r3a.py:160;"
                     " scripts/probe_r3b.py:109, 128, 153, 179, 218"),
}


PROBE_FAMILIES = ("capability", "rates", "copies")  # phase 13 runs the rest


def probes(dev) -> list[dict]:
    """The probes' path with the counts at 0 before it; returns the
    kernels-line entries of the four probe kernels."""
    from kmer_tpu_torch.kernels.row_sort import row_sort
    from kmer_tpu_torch.kernels.segment_copy import segment_copy
    from kmer_tpu_torch.kernels.tile_gather import tile_gather
    from kmer_tpu_torch.kernels.tile_stages import tile_stages
    from kmer_tpu_torch.probes import run_all

    wrappers = {"tile_gather": tile_gather, "tile_stages": tile_stages,
                "row_sort": row_sort, "segment_copy": segment_copy}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    records = run_all(dev, only=PROBE_FAMILIES, echo=log)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"probes: {len(records)} probes in {time.perf_counter() - t0:.1f} s;"
        f" launches {launches}")
    bad = [r.name for r in records if not r.correct]
    check(not bad, f"every probe equals its plain version and oracle "
          f"(not: {bad})")
    for r in records:
        if r.kernel == "tile_gather":
            lib = (r.library if r.library_ms is None
                   else f"{r.library} {r.library_ms:.4f} ms")
            log(f"tile_gather {r.name}: {r.graph_ms:.4f} ms (bound "
                f"{r.bound_ms:.6f} ms, {r.bound_by}) beside {lib}")
    entries = []
    for name, (probe, replaces) in PROBE_KERNELS.items():
        check(launches[name] > 0, f"the probes' path launched {name}")
        rec = next(r for r in records if r.name == probe)
        entries.append({
            "name": name, "route": "cuda",
            "source": f"kmer_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": float(max(r.max_abs_err for r in records
                                     if r.kernel == name)),
            "ms": rec.ms, "plain_ms": rec.plain_ms, "graph_ms": rec.graph_ms,
            "bound_ms": rec.bound_ms, "bound_by": rec.bound_by,
            "library_ms": rec.library_ms,
            "pct_of_bound": 100 * rec.bound_ms / rec.graph_ms,
        })
    return entries


# the overlap path's worst case: 32,768 copies of 1,024 words into 2^25
# words (the r3a serial family's copies), at random destinations and all
# at one offset
WORST_G, WORST_SEG = 32768, 1024


def device_ops(fn) -> tuple[int | None, list[str]]:
    """(count, names) of the device operations (kernels, memsets) that one
    call of ``fn`` runs, from a ``torch.profiler`` trace; count None where
    the trace holds no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return len(names) or None, names


def overlap_worst_cases(dev, rng) -> dict:
    """Times the two worst-case overlap plans (a CUDA graph, cold) beside
    the plain version, holding each against it; returns their records."""
    import torch

    from kmer_tpu_torch.kernels.segment_copy import (
        copy_plan, segment_copy, segment_copy_reference)
    from kmer_tpu_torch.probes.common import bound_ms, graph_ms, max_abs_err
    from kmer_tpu_torch.probes.copies import source

    n_out = WORST_G * WORST_SEG
    src = source(n_out, dev, seed=SEED)
    in_off = rng.integers(0, n_out - WORST_SEG + 1, WORST_G)
    out = {}
    for what, out_off in (
            ("random", rng.integers(0, n_out - WORST_SEG + 1, WORST_G)),
            ("one_offset", np.zeros(WORST_G, np.int64))):
        plan = copy_plan(in_off, out_off, WORST_SEG, n_out, n_out,
                         device=dev)
        check(plan.overlap, f"worst case {what}: destinations overlap")
        got = torch.zeros(n_out, dtype=src.dtype, device=dev)
        segment_copy(src, plan, got)
        t0 = time.perf_counter()
        ref = segment_copy_reference(src, plan)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        err = max_abs_err(got, ref)
        check(err == 0, f"worst-case overlap {what}: kernel == plain")
        # the words some copy covers are read once and written once
        cover = np.zeros(n_out + 1, np.int64)
        np.add.at(cover, out_off, 1)
        np.add.at(cover, out_off + WORST_SEG, -1)
        covered = int((np.cumsum(cover[:-1]) > 0).sum())
        bound, by = bound_ms(8 * covered + 16 * WORST_G, 0, dev)
        ms = graph_ms(lambda: segment_copy(src, plan, got), dev, cold=True)
        ops, names = device_ops(lambda: segment_copy(src, plan, got))
        out[what] = {"copies": WORST_G, "seg": WORST_SEG, "n_out": n_out,
                     "covered_words": covered, "device_ops_a_call": ops,
                     "max_abs_err": float(err), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
        log(f"segment_copy worst-case overlap, {what}: G={WORST_G} "
            f"SEG={WORST_SEG} into {n_out} words ({covered} covered): "
            f"graph {ms:.4f} ms, plain {plain_ms:.1f} ms, bound {bound:.6f} "
            f"ms ({by}, {100 * bound / ms:.2f}%); a call's device operations "
            f"in a torch.profiler trace: {ops} {names}")
        del got, ref
    return out


def probe_edges(dev) -> dict:
    """Kernel == plain version at edge shapes, exactly; returns the
    worst-case overlap plans' records."""
    import torch

    from kmer_tpu_torch.kernels.row_sort import row_sort, row_sort_reference
    from kmer_tpu_torch.kernels.segment_copy import (
        copy_plan, segment_copy, segment_copy_reference)
    from kmer_tpu_torch.kernels.tile_gather import (
        tile_gather, tile_gather_reference)
    from kmer_tpu_torch.kernels.tile_stages import (
        tile_stages, tile_stages_reference)

    edges = load_by_path(os.path.join(ROOT, "tests", "kernel_edges.py"))
    rng = np.random.default_rng(SEED + 2)

    def u32(shape):
        a = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(a.view(np.int32)).to(dev)

    def same(a, b, what):
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        check(all(torch.equal(x, y) for x, y in pairs),
              f"kernel == plain at the edge: {what}")

    for shape in edges.GATHER_SHAPES:
        x, idx = (torch.from_numpy(a.view(np.int32)).to(dev)
                  for a in edges.gather_case(shape, SEED))
        for steps in edges.GATHER_STEPS:
            kw = dict(tile_rows=shape[3], steps=steps, add=0xFFFFFFF0)
            same(tile_gather(x, idx, shape[2], **kw),
                 tile_gather_reference(x, idx, shape[2], **kw),
                 f"tile_gather {shape} steps {steps}")
    for n_table in edges.GATHER_TABLES:
        tab = u32((n_table,))
        for n_idx, lead in ((1, 0), (7, 1), (8192, 0), (8192, 1)):
            buf = torch.from_numpy(rng.integers(0, n_table, n_idx + 1).astype(
                np.int32)).to(dev)
            idx = buf[lead: lead + n_idx]
            same(tile_gather(tab, idx, None),
                 tile_gather_reference(tab, idx, None),
                 f"tile_gather, a {n_table}-word table, {n_idx} indices")
    shapes = [(8, 128, axis, None) for axis in (1, 0)] + edges.STAGE_SHAPES
    for n_rows, lanes, axis, tile_rows in shapes:
        x, lo2 = u32((n_rows, lanes)), u32((n_rows, lanes))
        for name, shifts in edges.SCHEDULES.items():
            sched = torch.tensor(shifts, dtype=torch.int32, device=dev)
            for op in ("take2", "min", "min_add1", "add1", "copy"):
                lo = lo2 if op == "take2" else None
                same(tile_stages(x, sched, op, axis, lo=lo,
                                 tile_rows=tile_rows),
                     tile_stages_reference(x, sched, op, axis, lo=lo,
                                           tile_rows=tile_rows),
                     f"tile_stages {op} [{n_rows},{lanes}] axis {axis} "
                     f"tile rows {tile_rows} schedule {name}")
    for shape in ((1, 128), (8, 128), (3, 1), (5, 1024)):
        x = u32(shape)
        same(row_sort(x), row_sort_reference(x), f"row_sort {shape}")
    n = 1 << 20
    src = u32((n,))
    for g, seg, at_end in ((1, 1, False), (1, 1, True), (3, 1, True),
                           (1, 1000, True), (257, 33, True)):
        in_off = rng.integers(0, n - seg + 1, g)
        if at_end:
            in_off[-1] = n - seg  # the copy ends at the source's last word
        plan = copy_plan(in_off, np.arange(g) * seg, seg, n, g * seg,
                         device=dev)
        same(segment_copy(src, plan), segment_copy_reference(src, plan),
             f"segment_copy G={g} SEG={seg}")
    for name in edges.OVERLAP_PLANS:
        in_off, out_off, seg, n_in, n_out = edges.overlap_plan(name, SEED)
        plan = copy_plan(in_off, out_off, seg, n_in, n_out, device=dev)
        small = src[:n_in].contiguous()
        same(segment_copy(small, plan), segment_copy_reference(small, plan),
             f"segment_copy overlapping plan {name}")
    torch.cuda.synchronize()
    log(f"probe kernels == plain at the edge shapes "
        f"({len(edges.GATHER_SHAPES)} gather shapes x "
        f"{len(edges.GATHER_STEPS)} step counts, {len(edges.GATHER_TABLES)} "
        f"tables; {len(shapes)} stage shapes x {len(edges.SCHEDULES)} "
        f"schedules x 5 ops; {len(edges.OVERLAP_PLANS)} overlapping copy "
        "plans)")
    return overlap_worst_cases(dev, rng)


def bench_on_card(dev, main_distinct: int, coverage_distinct: int
                  ) -> tuple[dict, int, dict, dict]:
    """The bench's modes on the card, held against phases 4 and 5; returns
    the count path's kernels' launches in them, the chr sequence's
    distinct count, the fused result at the benchmark entry's defaults
    and the stream and chr modes' walls in ms."""
    import torch

    from kmer_tpu_torch import bench
    from kmer_tpu_torch.ops.count import count_windows
    from kmer_tpu_torch.ops.extract import canonicalize, extract_windows

    def show(result):
        print(json.dumps(result), flush=True)
        for name, ph in result["detail"].get("phases", {}).items():
            log(f"  phase {name:>14}: {ph['ms']:.4f} ms, {ph['gb_per_s']} "
                f"GB/s, {ph['pct_sol']}% of the published peak")
        return result["detail"]["unique_kmers"]

    zero_launches()
    common = dict(read_len=READ_LEN, k=K, canonical=True, seed=SEED,
                  device=dev)
    got = show(bench.run_bench(n_reads=MAIN_READS, **common))
    check(got == main_distinct, f"fused bench distinct {got} == "
          f"{main_distinct} (phase 4)")
    stream = bench.run_bench_stream(n_reads=MAIN_READS, **common)
    got = show(stream)
    check(got == main_distinct, f"stream bench distinct {got} == "
          f"{main_distinct} (phase 4)")
    walls = {"bench stream": 1e3 * stream["detail"]["wall_s"]}
    got = show(bench.run_bench(n_reads=200_000, coverage_genome=1_000_000,
                               **common))
    check(got == coverage_distinct, f"coverage bench distinct {got} == "
          f"{coverage_distinct} (phase 5)")

    chr_k = 31
    result = bench.run_chr_bench(k=chr_k, seed=SEED, device=dev)
    got = show(result)
    walls["chr"] = 1e3 * result["detail"]["wall_s"]
    n_bases = result["detail"]["n_bases"]
    codes = torch.from_numpy(bench.chr_codes(n_bases, SEED)).to(dev)
    keys = canonicalize(extract_windows(codes, chr_k), chr_k)
    del codes
    second = count_windows(keys, None, chr_k).distinct()
    del keys
    check(got == second, f"chr bench distinct {got} == {second} "
          "(extract_windows + count_windows)")
    log(f"chr: {n_bases} bases, distinct {got} on both routes")

    small = show(bench.run_chr_bench(n_bases=1 << 24, k=chr_k, seed=SEED,
                                     device=dev))
    codes = bench.chr_codes(1 << 24, SEED)
    want = np.unique(oracle_keys(codes[None, :], chr_k, canonical=True)).size
    check(small == want, f"chr bench at 2^24 bases: distinct {small} == "
          f"{want} (numpy oracle)")
    # the benchmark entry's default workload (phase 12a runs the entry)
    entry = bench.run_bench(n_reads=1 << 20, read_len=READ_LEN, k=K,
                            canonical=True, device=dev)
    log(f"bench at the entry's defaults (2^20 reads, seed 0): distinct "
        f"{show(entry)}")
    # stream_keys: the stream mode's warm and timed runs, and the chr
    # mode's at both sizes
    launches = read_launches("the bench", {"codes_keys": 0,
                                           "stream_keys": 6})
    log(f"bench: exact on every mode; kernel launches {launches}")
    return launches, second, entry, walls


# --- phase 8: the streaming fold ---------------------------------------------

# (a): a sequencing run at 15x over one genome (10M reads, 30x, until the
# script passed ~600 s with phase 11)
GENOME_BASES, RUN_READS = 50_000_000, 5_000_000
RUN_CHUNK = 250_000  # reads written at a time
BUDGET = 1 << 19  # (c): the device slot budget
PER_BATCH = ("extract", "count", "compact", "merge")  # the fold's phases


def write_genome_run(path: str, genome_bases: int | None = None,
                     n_reads: int | None = None, seed: int = SEED + 8
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Reads sampled from one random genome (8a's sizes by default), half
    reverse-complemented (as ``simulate_coverage_reads`` draws them),
    written a chunk at a time so the host never holds all reads; returns
    (genome, starts)."""
    genome_bases = genome_bases or GENOME_BASES
    n_reads = n_reads or RUN_READS
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_bases, dtype=np.uint8)
    starts = rng.integers(0, genome_bases - READ_LEN + 1, n_reads)
    flip = rng.random(n_reads) < 0.5
    windows = np.lib.stride_tricks.sliding_window_view(genome, READ_LEN)
    with open(path, "wb") as f:
        for s in range(0, n_reads, RUN_CHUNK):
            reads = windows[starts[s: s + RUN_CHUNK]]  # a copy
            fl = flip[s: s + RUN_CHUNK]
            reads[fl] = 3 - reads[fl, ::-1]
            f.write(fastq_records(reads, first=s))
    return genome, starts


def genome_oracle(genome: np.ndarray, starts: np.ndarray, k: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(sorted canonical keys, counts) of the reads, from the genome: each
    genome window's canonical key weighted by the reads that cover it (a
    difference array over the read starts), grouped with numpy."""
    n_win = genome.size - k + 1
    cum = np.concatenate([[0], np.cumsum(np.bincount(starts,
                                                     minlength=n_win))])
    p = np.arange(n_win)
    weight = cum[p + 1] - cum[np.maximum(p - (READ_LEN - k), 0)]
    keys = oracle_keys(genome[None, :], k, canonical=True)
    keep = weight > 0
    keys, weight = keys[keep], weight[keep]
    order = np.argsort(keys)
    keys, weight = keys[order], weight[order]
    head = np.ones(keys.size, bool)
    head[1:] = keys[1:] != keys[:-1]
    first = np.flatnonzero(head)
    return keys[first], np.add.reduceat(weight, first)


def check_wide(table, keys: np.ndarray, counts: np.ndarray, k: int,
               what: str) -> None:
    """A fold's WideCounts must equal (keys, counts) exactly."""
    from kmer_tpu_torch.ops.wide import WideCounts
    from kmer_tpu_torch.packed import key_from_hi_lo

    check(isinstance(table, WideCounts), f"{what}: took the fold")
    t = table.trim()
    hi, lo, length, _, _ = t.to_numpy()
    got = key_from_hi_lo(hi, lo).view(np.uint64)
    check(np.array_equal(got, keys), f"{what}: keys equal")
    check(np.array_equal(t.counts64(), counts.astype(np.int64)),
          f"{what}: 64-bit counts equal")
    check(bool((length == k).all()), f"{what}: every length is k")
    check(table.distinct() == keys.size, f"{what}: n_unique")


def fold_run(dev, what: str, windows: int, path: str, **kw):
    """``count_file`` through the fold with the phases timed and the
    kernels' counts set to 0 before; returns (table, stats, launches)."""
    import torch

    from kmer_tpu_torch.pipeline import count_file
    from kmer_tpu_torch.utils.logging import StatsCounters
    from kmer_tpu_torch.utils.profiling import Profile

    stats, profile = StatsCounters(), Profile()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    table = count_file(path, "fastq", K, canonical=True, stats=stats,
                       profile=profile, device=dev, **kw)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = read_launches(f"{what}: the fold", WIRE_FED)
    per = {name: 1e3 * sec / max(stats.batches, 1)
           for name, sec in profile.phases.items() if name in PER_BATCH}
    once = {name: sec for name, sec in profile.phases.items()
            if name not in PER_BATCH}
    log(f"{what}: count_file {wall:.3f} s = {windows / wall:.1f} k-mers/s "
        f"(phases timed with a synchronize each); {stats.batches} batches, "
        f"kernel launches {launches}, growths {stats.grows}, spills "
        f"{stats.spills}, final slots {table.capacity}, distinct "
        f"{table.distinct()}, peak device memory "
        f"{torch.cuda.max_memory_allocated(dev)} bytes")
    log(f"{what}: per batch (ms): " + ", ".join(
        f"{name} {ms:.3f}" for name, ms in per.items()) + "; in all (s): "
        + ", ".join(f"{name} {sec:.3f}" for name, sec in once.items()))
    return table, stats, launches


def fold_phase(dev, tmp: str, main_fastq: str, main_table, cov_fastq: str,
               cov_table) -> tuple[dict, tuple]:
    """Phase 8; returns the count path's kernels' launches by case and
    8a's (FASTQ path, oracle keys, oracle counts)."""
    from kmer_tpu_torch.ops import wide
    from kmer_tpu_torch.pipeline import (
        PipelineCheckpoint, count_batches_pipelined, file_batch_feed)

    launches = {}
    # (a) a sequencing run
    path = os.path.join(tmp, "run.fastq")
    t0 = time.perf_counter()
    genome, starts = write_genome_run(path)
    log(f"8a: wrote {os.path.getsize(path)} bytes of FASTQ ({RUN_READS} "
        f"reads x {READ_LEN} bp from a {GENOME_BASES}-base genome) in "
        f"{time.perf_counter() - t0:.1f} s")
    windows = RUN_READS * (READ_LEN - K + 1)
    table, stats, launches["8a"] = fold_run(dev, "8a", windows, path)
    check(stats.grows > 0 and table.capacity > 1 << 24,
          "8a: the capacity grew from 2^24")
    t0 = time.perf_counter()
    rows = sum(int((ln > 0).sum()) for _, ln in
               file_batch_feed(path, "fastq", K, None, None)[0])
    log(f"8a: the host feed alone (parse + pack, no device): "
        f"{time.perf_counter() - t0:.3f} s for {rows} rows")
    t0 = time.perf_counter()
    keys, counts = genome_oracle(genome, starts, K)
    check(int(counts.sum()) == windows, "8a: the oracle counts every window")
    check_wide(table, keys, counts, K, "8a")
    log(f"8a: exact against the genome oracle ({time.perf_counter() - t0:.1f}"
        f" s); distinct {keys.size}, total {windows}")
    run = (path, keys, counts)  # phase 11 counts this run again
    del table, genome, starts

    # (b) state at size: phase 4's file again, its phases timed
    windows = MAIN_READS * (READ_LEN - K + 1)
    table, stats, launches["8b"] = fold_run(dev, "8b", windows, main_fastq)
    want_keys = main_table.keys.numpy().view(np.uint64)
    check_wide(table, want_keys, main_table.counts.numpy(), K, "8b")
    log(f"8b: equal to phase 4's table; {table.distinct()} live rows in "
        f"{table.capacity} slots")
    del table

    # (c) spill, merge and resume under a budget
    windows = cov_table.total()
    want_keys = cov_table.keys.numpy().view(np.uint64)
    want_counts = cov_table.counts.numpy()
    spills = os.path.join(tmp, "spills")
    table, stats, launches["8c"] = fold_run(
        dev, "8c", windows, cov_fastq, batch=4096, max_capacity=BUDGET,
        spill_dir=spills)
    check(stats.spills > 0, "8c: at least one spill")
    check((stats.spills + 1) * BUDGET <= wide._DEVICE_MERGE_MAX_ROWS,
          "8c: the spill runs merge on the device")
    check_wide(table, want_keys, want_counts, K, "8c, spills")
    feed, batch, width, _ = file_batch_feed(cov_fastq, "fastq", K, 4096, None)
    batches = list(feed)
    ck = os.path.join(tmp, "ck.npz")
    resumed = os.path.join(tmp, "resumed")
    count_batches_pipelined(
        iter(batches[: len(batches) // 2]), K, canonical=True,
        capacity=BUDGET, max_capacity=BUDGET, spill_dir=resumed,
        ckpt=PipelineCheckpoint(ck), ckpt_every_s=0.0, device=dev)
    done = PipelineCheckpoint(ck).batches_done
    check(done == len(batches) // 2, "8c: the half run checkpointed")
    table, stats, n = fold_run(
        dev, "8c resumed", windows, cov_fastq, batch=4096, width=width,
        max_capacity=BUDGET, spill_dir=resumed, ckpt_path=ck)
    launches["8c"] = {name: c + n[name] for name, c in launches["8c"].items()}
    check(stats.batches == len(batches) - done, "8c: the resume skipped "
          "the checkpointed batches")
    check_wide(table, want_keys, want_counts, K, "8c, resumed")
    log(f"8c: spilled and resumed runs equal phase 5's table "
        f"({len(batches)} batches, resumed at {done})")
    return launches, run



# --- phase 9: the SQL surface ------------------------------------------------


SQL_ROWS = 100_000  # kmer-tests.sql's dna_kmer_test table
SQL_PROBES = 48  # run_scale_parity's default; its oracle takes seconds


def run_cli(argv: list[str]) -> tuple[str, str]:
    """``python -m kmer_tpu_torch <argv>`` in this process (so launch
    counts are seen); returns (stdout, the ``#`` lines of stderr)."""
    import contextlib
    import io

    from kmer_tpu_torch.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    check(rc == 0, f"cli {' '.join(argv[:1])} exits 0")
    return out.getvalue(), "".join(
        ln for ln in err.getvalue().splitlines(True) if ln.startswith("#"))


def counts_printed(out: str) -> dict:
    pairs = (ln.split("\t") for ln in out.splitlines())
    return {kmer: int(n) for kmer, n in pairs}


def dna_column_oracle(dnas: list[str], k: int) -> dict:
    """{k-mer: count} over the k-windows of each dna string, with numpy:
    windows over the rows laid end to end, kept where they lie in one."""
    lut = np.full(256, 255, np.uint8)
    lut[np.frombuffer(b"ACGTacgt", np.uint8)] = [0, 1, 2, 3, 0, 1, 2, 3]
    codes = lut[np.frombuffer("".join(dnas).encode(), np.uint8)]
    lens = np.array([len(d) for d in dnas], np.int64)
    ends = np.cumsum(lens)
    m = codes.size - k + 1
    keys = np.zeros(m, np.uint64)
    for j in range(k):
        keys |= codes[j: j + m].astype(np.uint64) << np.uint64(62 - 2 * j)
    start = np.arange(m)
    row_end = ends[np.searchsorted(ends, start, side="right")]
    uniq, counts = np.unique(keys[start + k <= row_end], return_counts=True)
    shifts = np.uint64(62) - np.uint64(2) * np.arange(k, dtype=np.uint64)
    letters = LETTERS.tobytes().lower()
    strs = (np.frombuffer(letters, np.uint8)[
        (uniq[:, None] >> shifts[None, :]) & np.uint64(3)]).tobytes()
    return {strs[i * k: (i + 1) * k].decode(): int(c)
            for i, c in enumerate(counts)}


def sql_phase(dev, tmp: str, card: str) -> dict:
    """Phase 9; returns the count path's kernels' launches in (a) and (c)."""
    import collections

    import torch

    from kmer_tpu_torch.bench import run_pattern_bench, run_query_bench
    from kmer_tpu_torch.parity import run_parity, run_scale_parity

    kernels = count_path_kernels()
    launches = {}

    zero_launches()
    t0 = time.perf_counter()
    check(run_parity(device=dev), "9a: run_parity passes all 11 checks")
    launches["9a"] = {n: fn.launches for n, fn in kernels.items()}
    check(launches["9a"]["segment_counts"] > 0,
          "9a: run_parity launched the segment_counts kernel")
    log(f"9a: run_parity on {dev} in {time.perf_counter() - t0:.3f} s; "
        f"kernel launches {launches['9a']}")

    t0 = time.perf_counter()
    check(run_scale_parity(n_rows=SQL_ROWS, n_probes=SQL_PROBES, device=dev),
          "9b: scale parity")
    log(f"9b: run_scale_parity(n_rows={SQL_ROWS}, n_probes={SQL_PROBES}) on "
        f"{dev} in {time.perf_counter() - t0:.3f} s")

    csv_path = os.path.join(tmp, "sql_rows.csv")
    run_cli(["datagen", "--rows", str(SQL_ROWS), "--seed", "7",
             "--out", csv_path])
    with open(csv_path) as f:
        rows = [ln.rstrip("\n").split(",") for ln in f][1:]
    check(len(rows) == SQL_ROWS, "9c: datagen wrote every row")

    zero_launches()
    t0 = time.perf_counter()
    out, summary = run_cli(["count", "--input", csv_path, "-k", "8",
                            "--device", str(dev)])
    got = counts_printed(out)
    want = collections.Counter(r[1].lower() for r in rows)
    check(got == want, "9c: kmer-column GROUP BY equals collections.Counter")
    # equal keys of other lengths are other groups, so the kmer-column
    # GROUP BY must not reach the key-only segment-count kernel
    kmer_col = {n: fn.launches for n, fn in kernels.items()}
    check(not any(kmer_col.values()),
          "9c: count (kmer column) launched no count-path kernel")
    log(f"9c: count (kmer column) in {time.perf_counter() - t0:.3f} s, "
        f"{summary.strip()}, equal to collections.Counter; kernel launches "
        f"{kmer_col}")
    zero_launches()
    t0 = time.perf_counter()
    out, summary = run_cli(["count", "--input", csv_path, "-k", "8",
                            "--from-dna-column", "--device", str(dev)])
    t_dna = time.perf_counter() - t0
    launches["9c"] = read_launches("9c: count --from-dna-column", WIRE_FED)
    check(counts_printed(out) == dna_column_oracle([r[0] for r in rows], 8),
          "9c: dna-column 8-mer counts equal the numpy oracle")
    log(f"9c: count --from-dna-column -k 8 in {t_dna:.3f} s, "
        f"{summary.strip()}, equal to the numpy oracle; kernel launches "
        f"{launches['9c']}")

    t0 = time.perf_counter()
    eq_probe = want.most_common(1)[0][0]
    for flag, q in (("--eq", eq_probe), ("--prefix", "ac"),
                    ("--pattern", "angr")):
        base = ["query", "--input", csv_path, flag, q, "--device", str(dev)]
        scan, indexed = run_cli(base), run_cli(base + ["--index"])
        check(scan == indexed, f"9d: query {flag} {q}: index == scan")
        log(f"9d: query {flag} {q}: {scan[1].strip()} with and without "
            "--index")
    log(f"9d: 6 queries in {time.perf_counter() - t0:.3f} s")

    for what, fn, kw in (
            ("query bench", run_query_bench, {}),
            ("pattern bench", run_pattern_bench, {})):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        result = fn(device=dev, **kw)
        log(f"9e/f: {what} {kw or 'at its defaults'} in "
            f"{time.perf_counter() - t0:.3f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated(dev)} bytes ({card})")
        print(json.dumps(result), flush=True)
    return launches


# --- phase 10: the rest of the one-device engine ------------------------------

STEP_READS = 1 << 17  # (a), (e): reads a KmerCounter step / stream batch
DENSE_KS = (4, 6, 8, 10)  # (b): both routes timed at these k
CHR_BASES, CHR_K, CHR_CHUNK = 15 << 24, 31, 1 << 24  # (d): configs[4]
RESUME_BASES = 1 << 25  # (d): the resumable run's prefix
STREAM_BUDGET = 1 << 25  # (e): the spill run's slot budget
# (f): 250,000 rows (1,000,000 until phase 12 took the script past ~600 s)
SERVE_ROWS, SERVE_QUERIES, SERVE_CLIENTS = 250_000, 1000, 4


def same_rows(got_keys, got_counts, want, what: str) -> None:
    """(keys, counts) on any device equal a trimmed host table's."""
    import torch

    check(torch.equal(got_keys.cpu(), want.keys), f"{what}: keys equal")
    check(torch.equal(got_counts.cpu().to(torch.int64),
                      want.counts.to(torch.int64)), f"{what}: counts equal")


def counter_case(dev, reads, main_table) -> tuple[dict, tuple]:
    """10a; returns the launches and the merged table after 3 steps."""
    import torch

    from kmer_tpu_torch.config import EngineConfig
    from kmer_tpu_torch.models import KmerCounter
    from kmer_tpu_torch.ops.wide import merge_groups, table_groups

    cfg = EngineConfig(k=K, canonical=True, chunk_reads=STEP_READS,
                       read_len=READ_LEN)
    lengths = np.full(cfg.chunk_reads, READ_LEN, np.int32)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    counter = KmerCounter(cfg, device=dev)
    keys = counts = after3 = None
    for i, s in enumerate(range(0, MAIN_READS, cfg.chunk_reads)):
        part = reads[s: s + cfg.chunk_reads]
        groups = table_groups(counter.step(part, lengths[: part.shape[0]]))
        keys, counts = groups if keys is None else merge_groups(
            keys, counts, *groups)
        if i == 2:
            after3 = (keys.cpu(), counts.cpu())
    counter.check_exact()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    steps = -(-MAIN_READS // cfg.chunk_reads)
    launches = read_launches("10a", {"wire_keys": 0, "codes_keys": steps,
                                     "stream_keys": 0,
                                     "segment_counts": steps})
    same_rows(keys, counts, main_table, "10a: KmerCounter, merged")
    windows = MAIN_READS * cfg.windows_per_read()
    log(f"10a: KmerCounter k={K} canonical, {steps} steps of "
        f"{cfg.chunk_reads} reads merged: {wall:.3f} s = "
        f"{windows / wall:.1f} k-mers/s; equal to phase 4's table; "
        f"launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev)} bytes")
    return launches, after3


def dense_case(dev, reads) -> tuple[dict, dict]:
    """10b; returns the launches and the two routes' times by k."""
    import torch

    from kmer_tpu_torch.config import EngineConfig
    from kmer_tpu_torch.models import KmerCounter
    from kmer_tpu_torch.ops import count_kmers_auto
    from kmer_tpu_torch.ops.count import count_kmers
    from kmer_tpu_torch.ops.dense_count import (
        count_kmers_dense, dense_histogram, right_aligned_keys)
    from kmer_tpu_torch.kernels.codes_keys import codes_keys

    codes = torch.from_numpy(reads).to(dev)
    lens = torch.full((MAIN_READS,), READ_LEN, dtype=torch.int32,
                      device=dev)
    zero_launches()
    counter = KmerCounter(EngineConfig(k=6, canonical=True), device=dev)
    dense = None
    for s in range(0, MAIN_READS, STEP_READS):
        table = counter.step(codes[s: s + STEP_READS], lens[s: s + STEP_READS])
        c = table.counts.to(torch.int64)
        dense = c if dense is None else dense + c
    counter.check_exact()
    auto8 = count_kmers_auto(codes, lens, 8, True)
    torch.cuda.synchronize(dev)
    steps = -(-MAIN_READS // STEP_READS)
    launches = read_launches("10b: the dense route", {
        "wire_keys": 0, "codes_keys": steps + 1, "stream_keys": 0,
        "segment_counts": 0})
    # a dense step leaves its bin max on the device: no host sync
    torch.cuda.set_sync_debug_mode("error")
    try:
        counter.step(codes[:STEP_READS], lens[:STEP_READS])
        synced = None
    except RuntimeError as e:
        synced = e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(synced is None, f"10b: a dense KmerCounter step syncs: {synced}")
    live = dense > 0
    same_rows(table.keys[live], dense[live],
              count_kmers(codes, lens, 6, True).trim(),
              "10b: KmerCounter k=6 (dense) vs the sort route")
    auto = auto8.trim()
    same_rows(auto.keys, auto.counts, count_kmers(codes, lens, 8, True).trim(),
              "10b: count_kmers_auto k=8 (dense) vs the sort route")
    times = {}
    for k in DENSE_KS:
        routes = {"dense": lambda: count_kmers_dense(codes, lens, k, True),
                  "sort": lambda: count_kmers(codes, lens, k, True)}
        turns = {"dense": [], "sort": []}
        for name in ("dense", "sort", "sort", "dense", "dense", "sort"):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            int(routes[name]().n_unique)
            turns[name].append(1e3 * (time.perf_counter() - t0))
        # the first turn of each route warms it
        times[k] = {name: min(ms[1:]) for name, ms in turns.items()}
        # the histogram alone against torch.bincount (which syncs)
        keys, valid = codes_keys(codes, lens, k, True)
        values = right_aligned_keys(keys, k)
        nbins = 1 << 2 * k
        hist = dense_histogram(values, valid, k)
        lib = torch.bincount(torch.where(valid.reshape(-1), values.reshape(-1),
                                         nbins), minlength=nbins + 1)[:nbins]
        check(torch.equal(hist, lib), f"10b: k={k} histogram == bincount")
        times[k]["histogram"] = time_cuda(
            lambda: dense_histogram(values, valid, k), 5)
        times[k]["bincount"] = time_cuda(lambda: torch.bincount(torch.where(
            valid.reshape(-1), values.reshape(-1), nbins),
            minlength=nbins + 1), 5)
        del keys, valid, values, hist, lib
        log(f"10b: k={k}, canonical, {MAIN_READS} x {READ_LEN} reads: "
            f"dense {turns['dense']} ms, sort {turns['sort']} ms (in turns;"
            " each includes its codes_keys launch); the histogram alone "
            f"{times[k]['histogram']} ms, torch.bincount "
            f"{times[k]['bincount']} ms")
    log(f"10b: KmerCounter k=6 and count_kmers_auto k=8 equal the sort "
        f"route; a dense step makes no host sync; launches {launches}")
    return launches, times


def graft_case(dev) -> dict:
    """10c; returns the launches."""
    import torch

    from kmer_tpu_torch.graft_entry import entry

    fn, args = entry(dev)
    zero_launches()
    got = fn(*args)
    torch.cuda.synchronize(dev)
    launches = read_launches("10c", {"wire_keys": 0, "codes_keys": 1,
                                     "stream_keys": 0, "segment_counts": 1})
    cpu_fn, cpu_args = entry("cpu")
    want = cpu_fn(*cpu_args).trim()
    same_rows(got.trim().keys, got.trim().counts, want, "10c: graft entry")
    log(f"10c: graft entry on {dev}: {got.distinct()} distinct, equal to "
        f"its CPU result; launches {launches}")
    return launches


def long_sequence_case(dev, tmp: str, chr_distinct: int) -> dict:
    """10d; returns the launches of the fast and the resumable run."""
    import torch

    from kmer_tpu_torch.bench import chr_codes
    from kmer_tpu_torch.kernels.wire_keys import wire_keys, wire_keys_reference
    from kmer_tpu_torch.pipeline import _upload
    from kmer_tpu_torch.streaming import (
        ROW_MAX, chunk_wire, count_long_sequence, iter_chunks_with_overlap)
    from kmer_tpu_torch.utils.checkpoint import ResumableCount
    from kmer_tpu_torch.utils.logging import StatsCounters

    codes = chr_codes(CHR_BASES, SEED)
    parts = [part for part, _ in
             iter_chunks_with_overlap(codes, CHR_CHUNK, CHR_K)]
    n_chunks = len(parts)
    stats = StatsCounters()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    table = count_long_sequence(codes, CHR_K, True, chunk=CHR_CHUNK,
                                stats=stats, device=dev)
    distinct = table.distinct()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {"fast": read_launches(
        "10d", {"wire_keys": n_chunks, "segment_counts": 1, **WIRE_FED})}
    check(distinct == chr_distinct,
          f"10d: distinct {distinct} == phase 7's chr {chr_distinct}")
    windows = CHR_BASES - CHR_K + 1
    check(stats.kmers == windows, "10d: every window streamed")
    check(table.total() == windows,
          f"10d: the table's counts sum to the {windows} windows")
    # the kernel against its plain version, every slot, at the rows the
    # path lays out: a full chunk and the last, shorter one
    for which, part in (("first", parts[0]), ("last", parts[-1])):
        wire = _upload(chunk_wire(part, ROW_MAX, CHR_K), dev)
        got = wire_keys(wire, ROW_MAX, CHR_K, True)
        want = wire_keys_reference(wire, ROW_MAX, CHR_K, True)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"10d: wire_keys == its plain version on the {which} chunk's "
              f"{wire.shape[0]} rows of {ROW_MAX} bases")
        del wire, got, want
    log(f"10d: count_long_sequence {CHR_BASES} bases, k={CHR_K} canonical, "
        f"{n_chunks} chunks of {CHR_CHUNK}: {wall:.3f} s = "
        f"{windows / wall:.1f} k-mers/s; distinct {distinct} == phase 7's, "
        f"counts sum to the windows; wire_keys == its plain version on the "
        f"first and last chunks; {table.capacity} slots; launches "
        f"{launches['fast']}; peak device memory {peak} bytes")
    del table

    head = codes[:RESUME_BASES]
    fast = count_long_sequence(head, CHR_K, True, chunk=CHR_CHUNK,
                               device=dev).trim()
    chunks = len(list(iter_chunks_with_overlap(head, CHR_CHUNK, CHR_K)))
    half = chunks // 2
    ck = os.path.join(tmp, "long_sequence.ckpt.npz")
    zero_launches()
    t0 = time.perf_counter()
    first = ResumableCount(ck, device=dev)
    count_long_sequence(head[: half * (CHR_CHUNK - CHR_K + 1) + CHR_K - 1],
                        CHR_K, True, chunk=CHR_CHUNK, resumable=first,
                        device=dev)
    t1 = time.perf_counter()
    first.checkpoint()
    t_save = time.perf_counter() - t1
    t1 = time.perf_counter()
    rest = ResumableCount(ck, device=dev)
    t_load = time.perf_counter() - t1
    check(rest.shards_done == half, "10d: the checkpoint holds half the "
          "chunks")
    resumed = count_long_sequence(head, CHR_K, True, chunk=CHR_CHUNK,
                                  resumable=rest, device=dev).trim()
    wall = time.perf_counter() - t0
    launches["resumable"] = read_launches(
        "10d resumable", {"wire_keys": chunks, "segment_counts": chunks,
                          **WIRE_FED})
    same_rows(resumed.keys, resumed.counts, fast,
              "10d: resumed run vs the fast path")
    log(f"10d: resumable run over {RESUME_BASES} bases ({chunks} chunks, "
        f"checkpointed after {half}, resumed in a new ResumableCount): "
        f"{wall:.3f} s, of which the checkpoint's write {t_save:.3f} s "
        f"({os.path.getsize(ck)} bytes) and load {t_load:.3f} s; equal to "
        f"the fast path; launches {launches['resumable']}")
    return launches


def read_stream_case(dev, tmp: str, reads, main_table, after3) -> dict:
    """10e; returns the launches of the full run and the spill run."""
    import torch

    from kmer_tpu_torch.native import pack2bit_rows
    from kmer_tpu_torch.streaming import count_read_stream
    from kmer_tpu_torch.utils.logging import StatsCounters

    lengths = np.full(STEP_READS, READ_LEN, np.int32)
    batches = [(reads[s: s + STEP_READS], lengths[: min(STEP_READS,
                                                        MAIN_READS - s)])
               for s in range(0, MAIN_READS, STEP_READS)]
    t0 = time.perf_counter()
    for codes, _ in batches:
        pack2bit_rows(codes)
    log(f"10e: the host's pack2bit_rows of the {len(batches)} batches "
        f"alone: {time.perf_counter() - t0:.3f} s")
    launches = {}
    for what, use, kw in (
            ("full", batches, {}),
            ("spills", batches[:3], {
                "max_capacity": STREAM_BUDGET,
                "spill_dir": os.path.join(tmp, "stream_runs")}),
            ("spills in host memory", batches[:3], {
                "max_capacity": STREAM_BUDGET})):
        stats = StatsCounters()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        t0 = time.perf_counter()
        acc = count_read_stream(iter(use), K, True, stats=stats, device=dev,
                                **kw)
        host = acc.trim()
        wall = time.perf_counter() - t0
        launches[what] = read_launches(
            f"10e {what}", {"wire_keys": len(use), "segment_counts": len(use),
                            **WIRE_FED})
        spills = "in host memory"
        if what == "full":
            same_rows(host.keys, host.counts, main_table,
                      "10e: count_read_stream vs phase 4's table")
        else:
            if "spill_dir" in kw:
                spills = sum(f.startswith("spill_")
                             for f in os.listdir(kw["spill_dir"]))
                check(spills > 0, "10e: the budget forced spills")
            check(torch.equal(host.keys, after3[0])
                  and torch.equal(host.counts, after3[1]),
                  f"10e: {what}: equal to 10a's table after 3 steps")
        log(f"10e: count_read_stream {what}, {len(use)} batches of "
            f"{STEP_READS} reads: {wall:.3f} s (to the host table) = "
            f"{stats.kmers / wall:.1f} k-mers/s; distinct {host.distinct()};"
            f" spills {spills}; launches {launches[what]}; peak device "
            f"memory {torch.cuda.max_memory_allocated(dev)} bytes")
    return launches


def serve_queries(table, n: int, rng) -> list[str]:
    """n mixed EQ / PREFIX / PATTERN lines drawn from the table's rows."""
    ids = rng.integers(0, len(table), n)
    kmers = table.rows(ids)
    out = []
    for i, (_, kmer, qkmer) in enumerate(kmers):
        kind = i % 3
        if kind == 0:
            out.append(f"EQ {kmer}")
        elif kind == 1:
            out.append(f"PREFIX {kmer[: int(rng.integers(1, 7))]}")
        else:
            out.append(f"PATTERN {qkmer}")
    return out


def ask_line(out, inp, cmd: str) -> dict:
    """Send one command line to a server's ``out`` and read its answer
    from ``inp``."""
    out.write(cmd + "\n")
    out.flush()
    line = inp.readline()
    check(bool(line), f"serve answered {cmd!r}")
    return json.loads(line)


def serve_case(dev, tmp: str) -> dict:
    """10f; returns the launches of the 1,000 queries."""
    import socket
    import threading

    import torch

    from kmer_tpu_torch.api import KmerTable
    from kmer_tpu_torch.cli import _make_serve_executor

    path = os.path.join(tmp, "serve_rows.csv")
    t0 = time.perf_counter()
    run_cli(["datagen", "--rows", str(SERVE_ROWS), "--seed", "10",
             "--out", path])
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = KmerTable.from_csv(path, device=dev)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    table.create_index()
    t_index = time.perf_counter() - t0
    execute = _make_serve_executor(table)
    queries = serve_queries(table, SERVE_QUERIES,
                            np.random.default_rng(SEED + 10))
    execute(queries[0])  # warm
    zero_launches()
    answers, lat = [], []
    for q in queries:
        t0 = time.perf_counter()
        answers.append(execute(q))
        lat.append(time.perf_counter() - t0)
    launches = read_launches("10f", {"wire_keys": 0, "segment_counts": 0,
                                     **WIRE_FED})
    scans = {"EQ": table.scan_eq, "PREFIX": table.scan_prefix,
             "PATTERN": table.scan_pattern}
    for q, r in zip(queries, answers):
        parts = q.split(None, 1)
        want = scans[parts[0]](parts[1] if len(parts) > 1 else "")
        check("rows" in r and r["rows"] == want.tolist(),
              f"10f: {q!r} served == the scan on {dev}")
    check(table._jcol().key.device.type == dev.type,
          f"10f: the scanned column is on {dev}")
    ms = 1e3 * np.asarray(lat)
    log(f"10f: serve {SERVE_ROWS} rows on {dev}: datagen {t_gen:.3f} s, "
        f"load {t_load:.3f} s, index {t_index:.3f} s; {SERVE_QUERIES} "
        f"mixed EQ/PREFIX/PATTERN queries p50 {np.percentile(ms, 50):.4f} "
        f"ms, p99 {np.percentile(ms, 99):.4f} ms, max {ms.max():.4f} ms, "
        f"{sum(len(r['rows']) for r in answers)} rows, each equal to the "
        f"scan on {dev}; launches {launches}")
    del table, execute

    # a --wal server on phase 9's 100,000 rows: acks, kill -9, restart
    # with --tcp; its clients answer as the killed server's stdin did
    rows_csv = os.path.join(tmp, "sql_rows.csv")
    wal = os.path.join(tmp, "serve.wal")
    argv = [sys.executable, "-m", "kmer_tpu_torch", "serve", "--input",
            rows_csv, "--wal", wal, "--device", str(dev)]
    mutations = ["INSERT acgtacgt,acgtacgt,acgtacgt", "INSERT tttt,tttt,tttt",
                 "DELETE tttt", "INSERT ACGTTGCA,acgttgca,nnnn",
                 "DELETE acga"]
    probe = ["COUNT", "DISTINCT", "EQ acgtacgt", "EQ tttt", "EQ acgttgca",
             "EQ acga", "PREFIX acgt", "PATTERN angr", "GROUP 5"]

    def start(extra):
        p = subprocess.Popen(argv + extra, stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, text=True, cwd=ROOT)
        watchdog = threading.Timer(300, p.kill)
        watchdog.start()
        return p, watchdog

    def stop(p, watchdog):
        watchdog.cancel()
        p.kill()
        p.wait(timeout=60)

    t0 = time.perf_counter()
    p, dog = start([])
    try:
        ready = json.loads(p.stdout.readline())
        acks = [ask_line(p.stdin, p.stdout, m) for m in mutations]
        check(all("error" not in a for a in acks), f"10f: acks {acks}")
        want = [ask_line(p.stdin, p.stdout, q) for q in probe]
    finally:
        stop(p, dog)  # SIGKILL after the acks
    t_wal = time.perf_counter() - t0
    t0 = time.perf_counter()
    p, dog = start(["--tcp", "0"])
    try:
        ready2 = json.loads(p.stdout.readline())
        check(ready2["ready"] == want[0]["value"],
              f"10f: the replayed table holds every acked mutation "
              f"({ready['ready']} rows -> {ready2['ready']})")
        errs, got = [], []

        def client():
            try:
                with socket.create_connection(
                        ("127.0.0.1", ready2["tcp"]), timeout=120) as s:
                    f = s.makefile("rw")
                    for _ in range(3):
                        got.append([ask_line(f, f, q) for q in probe])
            except Exception as e:  # raised again below
                errs.append(e)

        threads = [threading.Thread(target=client)
                   for _ in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        check(not errs and not any(t.is_alive() for t in threads),
              f"10f: every TCP client finished ({errs})")
        check(len(got) == 3 * SERVE_CLIENTS and all(g == want for g in got),
              "10f: the TCP clients' answers equal the stdin answers")
    finally:
        stop(p, dog)
    log(f"10f: --wal server on {ready['ready']} rows: {len(mutations)} "
        f"acked mutations, kill -9 ({t_wal:.3f} s with start-up); restarted "
        f"with --tcp, replayed {ready2['ready']} rows, {SERVE_CLIENTS} "
        f"concurrent clients x 3 x {len(probe)} commands equal to the "
        f"stdin answers ({time.perf_counter() - t0:.3f} s with start-up)")
    return launches


def engine_phase(dev, tmp: str, main_table, chr_distinct: int
                 ) -> tuple[dict, dict]:
    """Phase 10; returns the count path's launches by case and 10b's
    times by route."""
    from kmer_tpu_torch.ops.extract import simulate_reads

    reads = simulate_reads(MAIN_READS, READ_LEN, seed=SEED)  # phase 4's
    launches = {}
    t0 = time.perf_counter()
    launches["10a"], after3 = counter_case(dev, reads, main_table)
    launches["10b"], dense_times = dense_case(dev, reads)
    launches["10c"] = graft_case(dev)
    for what, n in long_sequence_case(dev, tmp, chr_distinct).items():
        launches[f"10d {what}"] = n
    for what, n in read_stream_case(dev, tmp, reads, main_table,
                                    after3).items():
        launches[f"10e {what}"] = n
    del reads
    log(f"10a-e in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["10f"] = serve_case(dev, tmp)
    log(f"10f in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "kmer_tpu_torch", "selftest",
                          "--device", str(dev)], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    check(out.returncode == 0 and out.stdout.startswith("selftest ok"),
          f"10g: selftest --device {dev} ({out.stdout!r} {out.stderr[-500:]!r})")
    log(f"10g: {out.stdout.strip()} ({time.perf_counter() - t0:.3f} s with "
        "start-up)")
    return launches, dense_times


# --- phase 11: multi-device on the card ------------------------------------


RUN_SHARDS = 4  # (b): gloo ranks sharing the card, one FASTQ shard each
RUN_ACC = 1 << 24  # (b): each rank's slots: ~50M distinct keys / 4 ranks
NCCL_ACC = 1 << 28  # (a): the one rank's slots for phase 4's ~130M keys
# (a), DISTCOUNT_r05.json's durability case: 1M reads of a 5 Mbp genome
DURABLE_GENOME, DURABLE_BATCH, DURABLE_ACC = 5_000_000, 65536, 1 << 23
SHARD_READS, SHARD_LEN = 1 << 16, 160  # (c), (d): phase 4's reads, padded
SHQ_KEYS, SHQ_QUERIES = 1 << 22, 1 << 14  # (e)


def distcount_ranks(tmp: str, tag: str, argvs: list[list[str]],
                    timeout: float = 600) -> list[dict]:
    """One ``python -m kmer_tpu_torch distcount`` per argv, all started
    together; every one must exit 0 (each is killed on the way out).
    Returns their JSON lines; their logs go to ``<tmp>/<tag>.rank<i>.log``."""
    procs, logs = [], []
    try:
        for i, a in enumerate(argvs):
            logs.append(open(os.path.join(tmp, f"{tag}.rank{i}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kmer_tpu_torch", "distcount", *a],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=logs[-1],
                text=True))
        outs = []
        for p, lg in zip(procs, logs):
            out, _ = p.communicate(timeout=timeout)
            lg.seek(0)
            check(p.returncode == 0, f"{tag}: a distcount rank exited "
                  f"{p.returncode}: {lg.read()[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lg in logs:
            lg.close()


def rank_launches(what: str, outs: list[dict]) -> dict:
    """Every distcount rank (fed the packed wire) must have launched the
    wire-key and segment-count kernels and no codes- or stream-key
    kernel; returns their launches summed over the ranks."""
    total = {}
    for o in outs:
        launches = o["detail"]["launches"]
        check_launches(f"{what}: rank {o['rank']}", launches, WIRE_FED)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return total


def same_npz(a: str, b: str) -> bool:
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            np.array_equal(x[f], y[f]) for f in x.files)


def nccl_case(tmp: str, main_fastq: str, main_table) -> dict:
    """11a: distcount on one NCCL rank over phase 4's FASTQ equals phase
    4's table.  Then DISTCOUNT_r05.json's durability case (1M x 150 bp
    reads of a 5 Mbp genome, ~5M groups, batches of 65,536 reads, 2^23
    slots, a checkpoint every 4 batches): a straight run equals the
    genome oracle, and a run killed with -9 once its first checkpoint is
    on disk and then resumed writes the straight run's file bit for
    bit."""
    from kmer_tpu_torch.parallel.launch import free_port
    from kmer_tpu_torch.parallel.streaming import load_live

    def argv(path, *extra):
        return ["--input", path, "-k", str(K), "--canonical",
                "--coordinator", f"127.0.0.1:{free_port()}",
                "--num-processes", "1", "--process-id", "0", "--backend",
                "nccl", "--device", "cuda", *extra]

    launches = {}
    straight = os.path.join(tmp, "nccl")
    t0 = time.perf_counter()
    (out,) = distcount_ranks(tmp, "11a", [argv(
        main_fastq, "--acc-capacity", str(NCCL_ACC), "--out", straight)])
    wall = time.perf_counter() - t0
    launches["11a nccl"] = rank_launches("11a", [out])
    check(out["overflow"] == 0, "11a: no overflow")
    t, _ = load_live(straight + ".rank0.npz")
    check(np.array_equal(t.keys.numpy(), main_table.keys.numpy())
          and np.array_equal(t.counts.numpy(),
                             main_table.counts.numpy().astype(np.int64)),
          "11a: the rank file equals phase 4's table")
    d = out["detail"]
    log(f"11a: distcount, 1 NCCL rank, phase 4's FASTQ: {wall:.3f} s with "
        f"start-up, {d['elapsed_s']:.3f} s in the rank = "
        f"{d['kmers_per_s']:.1f} k-mers/s; {t.n_unique} groups, equal to "
        f"phase 4's table; launches {launches['11a nccl']}; peak device "
        f"memory {d['peak_device_bytes']} bytes")
    os.unlink(straight + ".rank0.npz")

    # the durability case of DISTCOUNT_r05.json
    r05 = os.path.join(tmp, "r05.fastq")
    genome, starts = write_genome_run(r05, DURABLE_GENOME, MAIN_READS,
                                      SEED + 11)
    keys, counts = genome_oracle(genome, starts, K)
    extra = ("--batch", str(DURABLE_BATCH), "--acc-capacity",
             str(DURABLE_ACC))
    plain = os.path.join(tmp, "r05_straight")
    t0 = time.perf_counter()
    (out,) = distcount_ranks(tmp, "11a_r05", [argv(r05, *extra, "--out",
                                                   plain)])
    wall = time.perf_counter() - t0
    launches["11a r05"] = rank_launches("11a r05", [out])
    t, _ = load_live(plain + ".rank0.npz")
    check(np.array_equal(t.keys.numpy().view(np.uint64), keys)
          and np.array_equal(t.counts.numpy(), counts.astype(np.int64)),
          "11a r05: equal to the genome oracle")
    ck, durable = os.path.join(tmp, "r05_ck"), os.path.join(tmp, "durable")
    extra += ("--ckpt", ck, "--ckpt-every", "4", "--out", durable)
    with open(os.path.join(tmp, "11a_killed.log"), "w+") as lg:
        t1 = time.perf_counter()
        p = subprocess.Popen([sys.executable, "-m", "kmer_tpu_torch",
                              "distcount", *argv(r05, *extra)], cwd=ROOT,
                             stdout=subprocess.DEVNULL, stderr=lg)
        try:
            while p.poll() is None and not os.path.exists(
                    ck + ".rank0.npz"):
                time.sleep(0.02)
            p.kill()
            p.wait()
        finally:
            if p.poll() is None:
                p.kill()
        killed_at = time.perf_counter() - t1
        lg.seek(0)
        submitted = [int(ln.split("checkpoint ")[1].split()[0])
                     for ln in lg if "checkpoint" in ln and "submitted" in ln]
    check(p.returncode == -9, f"11a: the run was killed (rc {p.returncode})")
    t1 = time.perf_counter()
    (out2,) = distcount_ranks(tmp, "11a_resumed", [argv(r05, *extra)])
    resume_wall = time.perf_counter() - t1
    with open(os.path.join(tmp, "11a_resumed.rank0.log")) as lg:
        resumed_at = [int(ln.split(" at batch ")[1].split()[0]) for ln in lg
                      if "resumed rank 0 at batch" in ln]
    check(len(resumed_at) == 1, "11a: the second run resumed")
    launches["11a resumed"] = rank_launches("11a resumed", [out2])
    check(same_npz(durable + ".rank0.npz", plain + ".rank0.npz"),
          "11a: the killed and resumed run's file equals the straight "
          "run's bit for bit")
    n_batches = -(-MAIN_READS // DURABLE_BATCH)
    reached = max(submitted, default=0)
    log(f"11a r05 (DISTCOUNT_r05.json's case, {keys.size} groups): straight "
        f"{wall:.3f} s with start-up ({out['detail']['elapsed_s']:.3f} s in "
        f"the rank), equal to the genome oracle; killed with -9 "
        f"{killed_at:.3f} s in, once its first rank checkpoint was on disk "
        f"(its log had submitted checkpoints {submitted}); resumed at batch "
        f"{resumed_at[0]} of {n_batches}, so it ran batches "
        f"{resumed_at[0] + 1}-{n_batches}, {max(reached - resumed_at[0], 0)}"
        f" of which the killed run had run too; resume {resume_wall:.3f} s "
        f"with start-up; its file equals the straight run's bit for bit; "
        f"launches {launches['11a resumed']}")
    return launches


def split_fastq(path: str, n_reads: int, parts: int, tmp: str) -> list[str]:
    """``parts`` record-aligned shards of a FASTQ of fixed-length
    records (``fastq_records``' layout)."""
    rec = 9 + 1 + READ_LEN + 3 + READ_LEN + 1
    per = n_reads // parts
    out = []
    with open(path, "rb") as f:
        for i in range(parts):
            shard = os.path.join(tmp, f"run_shard{i}.fastq")
            n = per if i < parts - 1 else n_reads - per * (parts - 1)
            with open(shard, "wb") as g:
                left = n * rec
                while left:
                    chunk = f.read(min(left, 64 << 20))
                    g.write(chunk)
                    left -= len(chunk)
            out.append(shard)
    return out


def gloo_distcount_case(tmp: str, run: tuple) -> dict:
    """11b: distcount on 4 gloo ranks sharing the card, mesh (4,1), over
    8a's reads in 4 record-aligned shards; the merged rank files equal
    8a's genome oracle."""
    from kmer_tpu_torch.packed import key_from_hi_lo
    from kmer_tpu_torch.parallel.driver import merge_rank_files
    from kmer_tpu_torch.parallel.launch import free_port

    path, keys, counts = run
    t0 = time.perf_counter()
    shards = split_fastq(path, RUN_READS, RUN_SHARDS, tmp)  # 12c: path
    log(f"11b: split 8a's FASTQ into {RUN_SHARDS} record-aligned shards in "
        f"{time.perf_counter() - t0:.1f} s")
    out_stem = os.path.join(tmp, "gloo")
    port = free_port()
    argvs = [["--input", shard, "-k", str(K), "--canonical", "--coordinator",
              f"127.0.0.1:{port}", "--num-processes", str(RUN_SHARDS),
              "--process-id", str(i), "--backend", "gloo", "--device",
              "cuda", "--batch", "131072", "--width", "160",
              "--acc-capacity", str(RUN_ACC), "--out", out_stem]
             for i, shard in enumerate(shards)]
    t0 = time.perf_counter()
    outs = distcount_ranks(tmp, "11b", argvs)
    wall = time.perf_counter() - t0
    launches = rank_launches("11b", outs)
    staged = set()
    for o in sorted(outs, key=lambda o: o["rank"]):
        d = o["detail"]
        check(o["overflow"] == 0, f"11b: rank {o['rank']} overflowed")
        staged.update(d["staged_collectives"])
        log(f"11b: rank {o['rank']}: {d['elapsed_s']:.3f} s, "
            f"{d['kmers_per_s']:.1f} k-mers/s of its shard, peak device "
            f"memory {d['peak_device_bytes']} bytes, merge efficiency "
            f"{d['merge_efficiency']:.4f}, {o['local_groups']} groups, "
            f"launches {d['launches']}")
    for shard in shards:
        os.unlink(shard)
    t0 = time.perf_counter()
    merged = merge_rank_files([f"{out_stem}.rank{i}.npz"
                               for i in range(RUN_SHARDS)])
    hi, lo, _, _, _ = merged.to_numpy()
    check(np.array_equal(key_from_hi_lo(hi, lo).view(np.uint64), keys)
          and np.array_equal(merged.counts64(), counts.astype(np.int64)),
          "11b: merge_rank_files equals 8a's genome oracle")
    total = int(counts.sum())
    log(f"11b: 4 gloo ranks, mesh (4,1): {wall:.3f} s with start-up = "
        f"{total / wall:.1f} k-mers/s; merge_rank_files equals 8a's genome "
        f"oracle ({merged.n_unique} groups, {total} k-mers; merge and "
        f"check {time.perf_counter() - t0:.1f} s); collectives staged "
        f"through the host: {sorted(staged)}; launches {launches}")
    return launches


def _card_rank():
    """This rank's card (a World rank of ``multi_phase``)."""
    import torch

    from kmer_tpu_torch.parallel.multihost import local_rank, rank_device

    dev = rank_device("cuda", local_rank())
    torch.cuda.set_device(dev)
    return dev


def sharded_rank(n_reads: int, read_len: int) -> dict:
    """11c and 11d on one rank of a (2,2) mesh: count_kmers_sharded with
    both merges and a forced overflow, and KmerCounter.count_sharded,
    each equal to the one-device count of the whole batch."""
    import torch

    from kmer_tpu_torch.config import EngineConfig
    from kmer_tpu_torch.models.pipeline import KmerCounter
    from kmer_tpu_torch.ops.count import count_kmers
    from kmer_tpu_torch.ops.extract import simulate_reads
    from kmer_tpu_torch.parallel import comm, dist
    from kmer_tpu_torch.parallel.dist import (
        _bucket_of, count_kmers_sharded, make_sharded_count_step)
    from kmer_tpu_torch.parallel.mesh import make_mesh

    dev = _card_rank()
    mesh = make_mesh((2, 2), device=dev)
    reads = np.zeros((n_reads, read_len), np.uint8)
    reads[:, :READ_LEN] = simulate_reads(n_reads, READ_LEN, seed=SEED)
    lengths = np.full(n_reads, READ_LEN, np.int32)
    one = count_kmers(torch.from_numpy(reads).to(dev),
                      torch.from_numpy(lengths).to(dev), K,
                      canonical=True).trim()
    mine = _bucket_of(one.keys, one.length, mesh.n_parts) == mesh.rank
    def at_cap_8(fn):
        """fn() with every partition bucket cut to 8 slots."""
        real = dist.bucket_cap
        dist.bucket_cap = lambda slots, n_parts, slack: 8
        try:
            return fn()
        finally:
            dist.bucket_cap = real

    _, ovf = at_cap_8(lambda: make_sharded_count_step(
        mesh, K, True, "partition")(reads, lengths))
    check(int(ovf) > 0, "11c: a bucket cap of 8 overflows")
    out = {"overflow at cap 8": int(ovf)}
    model = KmerCounter(EngineConfig(k=K, canonical=True, mesh_shape=(2, 2)),
                        device=dev)
    for case, run, whole in (
            ("gather", lambda: count_kmers_sharded(
                reads, lengths, K, mesh, True, "gather"), True),
            ("partition", lambda: count_kmers_sharded(
                reads, lengths, K, mesh, True, "partition"), False),
            ("forced overflow", lambda: at_cap_8(lambda: count_kmers_sharded(
                reads, lengths, K, mesh, True, "partition")), True),
            ("count_sharded", lambda: model.count_sharded(reads, lengths),
             True)):
        zero_launches()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        table = run()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = read_launches(f"11c {case}", {"wire_keys": 0,
                                                 "stream_keys": 0})
        t = table.trim()
        want = (one.keys, one.counts) if whole else (one.keys[mine],
                                                     one.counts[mine])
        check(torch.equal(t.keys, want[0]) and torch.equal(t.counts, want[1]),
              f"11c {case}: equal to the one-device table")
        check(int(table.n_unique) == one.n_unique, f"11c {case}: n_unique")
        out[case] = {"wall_s": wall, "rows": t.n_unique,
                     "launches": launches}
    out["staged"] = sorted(comm.STAGED)
    return out


def shq_rank(n_keys: int, n_queries: int) -> dict:
    """11e on one rank: ``run_sharded_query_bench`` (its counts are held
    against a one-device DeviceIndex inside)."""
    from kmer_tpu_torch.bench import run_sharded_query_bench
    from kmer_tpu_torch.parallel import comm

    dev = _card_rank()
    zero_launches()
    result = run_sharded_query_bench(n_keys, n_queries, device=dev)
    result["launches"] = read_launches("11e", {"wire_keys": 0,
                                               "segment_counts": 0,
                                               **WIRE_FED})
    result["staged"] = sorted(comm.STAGED)
    return result


def multi_phase(tmp: str, main_fastq: str, main_table, run) -> dict:
    """Phase 11; returns the count path's launches by case, summed over
    the ranks."""
    from kmer_tpu_torch.graft_entry import dryrun_multichip
    from kmer_tpu_torch.parallel.launch import World

    launches = {}
    t0 = time.perf_counter()
    launches.update(nccl_case(tmp, main_fastq, main_table))
    log(f"11a in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["11b, 4 ranks"] = gloo_distcount_case(tmp, run)
    log(f"11b in {time.perf_counter() - t0:.1f} s")

    def summed(per_rank):
        return {name: sum(r[name] for r in per_rank)
                for name in per_rank[0]}

    t0 = time.perf_counter()
    with World(4, "gloo", "cuda", timeout_s=300) as world:
        got = world.run(sharded_rank, SHARD_READS, SHARD_LEN)
        for case in ("gather", "partition", "forced overflow",
                     "count_sharded"):
            tag = "11d" if case == "count_sharded" else "11c"
            launches[f"{tag} {case}"] = summed(
                [g[case]["launches"] for g in got])
            log(f"{tag} {case}, (2,2) over 4 gloo ranks, {SHARD_READS} x "
                f"{READ_LEN} bp: equal to the one-device table on every "
                f"rank; walls {[round(g[case]['wall_s'], 4) for g in got]}"
                f" s; rows {[g[case]['rows'] for g in got]}; launches "
                f"{launches[f'{tag} {case}']}")
        log(f"11c: the step at a bucket cap of 8 overflowed by "
            f"{got[0]['overflow at cap 8']}; collectives staged through "
            f"the host: {got[0]['staged']}")
        shq = world.run(shq_rank, SHQ_KEYS, SHQ_QUERIES)
        launches["11e shq"] = summed([r["launches"] for r in shq])
        d = shq[0]["detail"]
        log(f"11e: bench --mode shq's run over 4 gloo ranks, {d['n_keys']} "
            f"keys, {d['n_queries']} queries: {shq[0]['value']} lookups/s "
            f"(rank 0), build {d['build_s']} s, lookup {d['lookup_s']} s, "
            f"{d['hits']} hits; every rank's counts equal the one-device "
            f"DeviceIndex's; launches {launches['11e shq']}")
    log(f"11c-e in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    zero_launches()
    dry = dryrun_multichip(4, "cuda", timeout_s=300)
    for r, n in enumerate(dry["launches"]):  # the codes and the wire fed
        check_launches(f"11d dryrun: rank {r}", n, {"stream_keys": 0})
    launches["11d dryrun"] = summed(dry["launches"])
    for name, n in count_path_kernels().items():  # the one-rank fold here
        launches["11d dryrun"][name] += n.launches
    log(f"11d: dryrun_multichip(4) on the card, mesh {dry['shape']}, "
        f"{dry['spills']} spill runs, in {time.perf_counter() - t0:.1f} s; "
        f"launches by rank {dry['launches']}")
    return launches


# --- phase 12: the long runs ------------------------------------------------

ENTRY_FIELDS = ("mode", "n_reads", "read_len", "k", "canonical",
                "total_kmers", "unique_kmers")


def entry_case(entry_want: dict, **env_extra: str) -> dict:
    """12a: the benchmark entry in a child at its defaults (fused, 2^20
    reads, cuda; ``env_extra`` sets others for a rehearsal on the CPU);
    returns its launches."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KMER_BENCH_")}
    env.update(KMER_BENCH_MODE="fused", **env_extra)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "kmer_tpu_torch.bench_entry"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    wall = time.perf_counter() - t0
    check(p.returncode == 0, f"12a: the entry exited {p.returncode}: "
          f"{p.stderr[-3000:]}")
    out = p.stdout.splitlines()
    check(len(out) == 1, f"12a: {len(out)} lines on stdout, not 1")
    result = json.loads(out[0])
    details = [json.loads(ln)["detail"] for ln in p.stderr.splitlines()
               if ln.startswith('{"detail": ')]
    check(len(details) == 1, "12a: one detail line on stderr")
    detail = details[0]
    want = {k: v for k, v in entry_want.items() if k != "detail"}
    check(set(result) == set(want), f"12a: stdout keys {sorted(result)}")
    for key in ENTRY_FIELDS:
        check(detail[key] == entry_want["detail"][key],
              f"12a: {key} {detail[key]} == phase 7's "
              f"{entry_want['detail'][key]}")
    launches = check_launches("12a", detail["launches"], WIRE_FED)
    log(f"12a: bench_entry (fused, 2^20 reads) in {wall:.3f} s with "
        f"start-up: {out[0]}; counts equal phase 7's in-process run "
        f"(distinct {detail['unique_kmers']}); records surfaced "
        f"{sorted(set(detail) & {'sustained', 'out_of_core_ingest'})}; "
        f"launches {launches}")
    return launches


def sustained_case(dev, tmp: str, cfg=None) -> dict:
    """12b: the sustained stream at full size (``cfg`` shrinks it for a
    rehearsal), straight here, killed and resumed in children; returns
    the launches of the three runs."""
    from kmer_tpu_torch.runs import sustained as sus

    cfg = cfg or sus.Config()
    full = cfg.full_size
    d = os.path.join(tmp, "sustained")
    zero_launches()
    t0 = time.perf_counter()
    straight = sus.run_phase("straight", cfg, d, dev)
    wall = time.perf_counter() - t0
    # one codes_keys and one segment count a batch, and the warm-up's
    runs = {"straight": read_launches("12b straight", {
        "wire_keys": 0, "codes_keys": cfg.steps + 1, "stream_keys": 0,
        "segment_counts": cfg.steps + 1})}
    check(straight["distinct"] == sus.FULL_DISTINCT or not full,
          f"12b: straight distinct {straight['distinct']}")
    log(f"12b straight: {cfg.steps} batches of {cfg.batch_reads} reads, "
        f"{straight['total_kmers']} k-mers in {straight['wall_s']:.3f} s = "
        f"{straight['kmers_per_s_sustained']:.1f} k-mers/s; "
        f"{straight['n_checkpoints']} checkpoints, stall "
        f"{straight['checkpoint_stall_s']:.4f} s "
        f"({straight['checkpoint_overhead_pct']:.3f}%); set-up "
        f"{straight['setup_s']:.3f} s; phase {wall:.3f} s; launches "
        f"{runs['straight']}")

    t0 = time.perf_counter()
    p = subprocess.run(sus.child_argv("kill", cfg, d, str(dev)), cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(p.returncode == 1, f"12b: the kill child exited {p.returncode}: "
          f"{p.stderr[-3000:]}")
    with open(os.path.join(d, "kill.json")) as f:
        kill = json.load(f)
    check(kill["killed_at_batch"] == cfg.kill_after, "12b: killed at 56")
    runs["kill"] = kill["launches"]
    check(runs["kill"] == {"wire_keys": 0, "codes_keys": cfg.kill_after + 1,
                           "stream_keys": 0,
                           "segment_counts": cfg.kill_after + 1},
          f"12b: the kill child's launches {runs['kill']}")
    log(f"12b kill: os._exit(1) after {kill['killed_at_batch']} batches, "
        f"{kill['wall_s']:.3f} s in, {kill['n_checkpoints']} checkpoints "
        f"landed (batch {kill['checkpoint_batches_done']}); child "
        f"{wall:.3f} s with start-up")

    t0 = time.perf_counter()
    p = subprocess.run(sus.child_argv("resume", cfg, d, str(dev)), cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(p.returncode == 0, f"12b: the resume child exited "
          f"{p.returncode}: {p.stderr[-3000:]}")
    resume = json.loads(p.stdout.strip().splitlines()[-1])
    check(resume["start_batch"] >= cfg.ckpt_every
          and resume["steps_run_this_process"] > 0,
          f"12b: resumed at batch {resume['start_batch']}")
    check(resume["resumed_equals_straight"] and resume["oracle_equal"]
          and resume["totals_exact"], "12b: the resume's checks")
    check(resume["distinct"] == sus.FULL_DISTINCT or not full,
          "12b: 999,980 groups")
    runs["resume"] = resume["launches"]
    check(runs["resume"] == {
        "wire_keys": 0,
        "codes_keys": resume["steps_run_this_process"] + 1,
        "stream_keys": 0,
        "segment_counts": resume["steps_run_this_process"] + 1},
        f"12b: the resume child's launches {runs['resume']}")
    log(f"12b resume: from batch {resume['start_batch']}, "
        f"{resume['steps_run_this_process']} batches in "
        f"{resume['wall_s']:.3f} s = {resume['kmers_per_s_sustained']:.1f} "
        f"k-mers/s; child {wall:.3f} s with start-up; equal to the straight "
        f"table bit for bit and to the numpy oracle ({resume['distinct']} "
        f"groups); launches {runs['resume']}")
    return {name: sum(r[name] for r in runs.values())
            for name in runs["straight"]}


def top_rows(keys: np.ndarray, counts: np.ndarray, top: int) -> list:
    """The CLI's first ``top`` rows of an oracle: by descending count,
    then ascending key."""
    from kmer_tpu_torch.packed import PackedKmers

    order = np.argsort(-counts, kind="stable")[:top]
    k = keys[order]
    strs = PackedKmers(hi=(k >> np.uint64(32)).astype(np.uint32),
                       lo=(k & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                       length=np.full(k.size, K, np.int32)).to_strings()
    return [[s, int(c)] for s, c in zip(strs, counts[order])]


def ingest_case(dev, tmp: str, run: tuple, **ckpt_kw) -> dict:
    """12c: ``runs.ingest``'s count under the RSS budget and its
    checkpointed kill and resume, on 8a's FASTQ (``ckpt_kw``: a smaller
    batch and interval for a rehearsal); returns the children's
    launches."""
    from kmer_tpu_torch.runs import ingest

    path, keys, counts = run
    d = os.path.join(tmp, "ingest")
    os.makedirs(d, exist_ok=True)
    big, failed = ingest.big_phase(path, d, 4000, str(dev), full=False)
    raw, base, libs = (big["big_child_peak_rss_bytes"],
                       big["big_child_baseline_rss_bytes"],
                       big["big_child_baseline_library_rss_bytes"])
    # a raw 4 GB check fails on a host that counts every page of
    # a mapped library as resident: it is printed, and the gate is the
    # peak less an idle child's resident library pages (PERF.md section 4)
    check(raw - libs < 4e9, f"12c: the count's peak RSS less an idle "
          f"child's library pages: {raw} - {libs} B, under 4 GB")
    check(big["big_distinct"] == keys.size
          and big["big_total_kmers"] == int(counts.sum()),
          "12c: the count's groups and total equal 8a's oracle")
    check(big["big_top3"] == top_rows(keys, counts, 3),
          f"12c: top rows {big['big_top3']}")
    runs = {"count": big["big_launches"]}
    log(f"12c count: {big['big_file_gb']:.3f} GB in "
        f"{big['big_count_wall_s']:.3f} s with start-up "
        f"({big['big_count_s_in_child']} s counting, "
        f"{big['big_feed_gb_per_s']:.4f} GB/s); peak RSS {raw} bytes, an "
        f"idle child's (torch, the CLI, the card) {base}, {libs} of it "
        f"shared libraries' pages; the peak less those {raw - libs} "
        f"(budget 4 GB); checks that failed: {failed or 'none'} (raw 4 GB "
        f"{'passed' if raw < 4e9 else 'FAILED'}); groups, total and top 3 "
        f"equal 8a's oracle; launches {runs['count']}")

    rec, failed = ingest.ckpt_phase(path, d, str(dev), **ckpt_kw)
    check(not failed, f"12c: {failed}")
    hi, lo, length, c64 = ingest.load_table(os.path.join(d,
                                                         "straight.ck.npz"))
    got = (hi.astype(np.uint64) << np.uint64(32)) | lo
    check(np.array_equal(got, keys) and np.array_equal(c64, counts)
          and bool((length == K).all()),
          "12c: the straight count --ckpt table equals 8a's oracle")
    runs.update(rec["launches"])
    for name, n in runs.items():
        check_launches(f"12c {name}", n, WIRE_FED)
    log(f"12c ckpt: the CLI's count --ckpt (defaults, a checkpoint every "
        f"60 s) {rec['straight_wall_s']:.3f} s with start-up "
        f"({rec['straight_count_s_in_child']} s counting, "
        f"{rec['straight_batches']} batches) wrote "
        f"{rec['cli_default_checkpoints_written']} checkpoint(s); its table "
        f"equals 8a's oracle; a count_file child checkpointing every "
        f"{rec['ckpt_every_s']:.3f} s was killed {rec['kill_after_s']:.3f} "
        f"s in after {rec['checkpoints_landed_before_kill']} checkpoints "
        f"(batch {rec['killed_checkpoint_batches_done']}); the resume ran "
        f"batches {rec['resumed_from_batch'] + 1}-{rec['straight_batches']}"
        f" in {rec['resume_wall_s']:.3f} s with start-up and equals the "
        f"straight table bit for bit; launches {rec['launches']}")
    return {name: sum(r[name] for r in runs.values())
            for name in runs["count"]}


def long_runs_phase(dev, tmp: str, entry_want: dict, run: tuple) -> dict:
    """Phase 12; returns the count path's launches by case."""
    launches = {}
    for tag, fn, args in (("12a", entry_case, (entry_want,)),
                          ("12b", sustained_case, (dev, tmp)),
                          ("12c", ingest_case, (dev, tmp, run))):
        t0 = time.perf_counter()
        launches[tag] = fn(*args)
        log(f"{tag} in {time.perf_counter() - t0:.1f} s")
    return launches


# --- phase 13: the sort probes and the sample-partition engine -------------

STAGE1_SHAPE = (8320, 1 << 14)  # config C's stage-1 rows, int64
SORT_PHASE_BUDGET_S = 90


def sort_phase(dev) -> tuple[dict, dict]:
    """Phase 13; returns the launches by family of the four kernels it
    counts, and row_sort's record at config C's stage-1 shape."""
    import torch

    from kmer_tpu_torch.kernels.row_sort import row_sort, row_sort_reference
    from kmer_tpu_torch.kernels.segment_copy import segment_copy
    from kmer_tpu_torch.kernels.segment_counts import segment_counts
    from kmer_tpu_torch.kernels.wire_keys import stream_keys, wire_keys
    from kmer_tpu_torch.probes import partition, sorting
    from kmer_tpu_torch.probes.common import bound_ms, graph_ms, max_abs_err

    wrappers = {"row_sort": row_sort, "segment_copy": segment_copy,
                "segment_counts": segment_counts, "wire_keys": wire_keys,
                "stream_keys": stream_keys}
    launches, summary = {}, []
    for family in (sorting, partition):
        tag = f"{family.__name__.rsplit('.', 1)[-1]} (13)"
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        records = []
        for rec in family.run(dev):
            log(rec.line())
            records.append(rec)
        launches[tag] = {name: fn.launches for name, fn in wrappers.items()}
        bad = [r.name for r in records if not r.correct]
        check(not bad, f"13 {tag}: every probe correct (not: {bad})")
        log(f"13 {tag}: {len(records)} probes in "
            f"{time.perf_counter() - t0:.1f} s; launches {launches[tag]}")
        summary += [{key: getattr(r, key) for key in (
            "name", "kernel", "ms", "plain_ms", "graph_ms", "bound_ms",
            "bound_by", "library_ms", "detail")} for r in records]
    for name in ("row_sort", "segment_copy"):
        check(launches["sorting (13)"][name] > 0,
              f"13: the sorting probes launched {name}")
    for name in ("row_sort", "segment_copy", "segment_counts",
                 "stream_keys"):  # stream_keys: the lanes
        check(launches["partition (13)"][name] > 0,
              f"13: the partition engines launched {name}")
    print(json.dumps({"phase13": summary}), flush=True)

    x = partition.make_lanes(False, dev).view(*STAGE1_SHAPE)
    got, ref = row_sort(x), row_sort_reference(x)
    err = max_abs_err(got.view(torch.int32), ref.view(torch.int32))
    check(err == 0, f"13: row_sort == plain at {list(x.shape)} int64")
    del got, ref
    bound, by = bound_ms(2 * x.nbytes, sorting.sort_ops(x.numel(),
                                                        x.shape[1]), dev)
    own = graph_ms(lambda: row_sort(x), dev, cold=True)
    lib = graph_ms(lambda: torch.sort(x, dim=1), dev, cold=True)
    at_stage1 = {"shape": list(x.shape), "dtype": "int64",
                 "max_abs_err": float(err), "ms": own, "bound_ms": bound,
                 "bound_by": by, "library": "torch.sort(x, dim=1)",
                 "library_ms": lib, "pct_of_bound": 100 * bound / own}
    log(f"13c: row_sort at config C's stage 1 {list(x.shape)} int64: "
        f"{own:.4f} ms in a CUDA graph (cold L2), bound {bound:.4f} ms "
        f"({by}, {100 * bound / own:.1f}%), torch.sort(dim=1) {lib:.4f} ms")
    del x
    partition.make_lanes.cache_clear()
    torch.cuda.empty_cache()
    return launches, at_stage1


# --- phase 14: the phase probes ----------------------------------------------

PHASE_PROBES_BUDGET_S = 180


def phase_probes(dev) -> dict:
    """Phase 14; returns each family's launches of the count path's
    kernels."""
    from kmer_tpu_torch.probes import FAMILIES, PHASE_KERNELS

    launches, summary = {}, []
    with tempfile.TemporaryDirectory(prefix="phase14_") as tmp:
        for name, kernels in PHASE_KERNELS.items():
            zero_launches()
            t0 = time.perf_counter()
            records = []
            for rec in FAMILIES[name].run(dev, workdir=tmp):
                log(rec.line())
                records.append(rec)
            want = {k: ((1, float("inf")) if k in kernels
                        else (0, float("inf")))
                    for k in count_path_kernels()}
            launches[f"{name} (14)"] = read_launches(f"14 {name}", want)
            bad = [r.name for r in records if not r.correct]
            check(not bad, f"14 {name}: every probe correct (not: {bad})")
            log(f"14 {name}: {len(records)} probes in "
                f"{time.perf_counter() - t0:.1f} s; launches "
                f"{launches[f'{name} (14)']}")
            for r in records:
                out = dataclasses.asdict(r)
                if out.get("tables"):
                    out["tables"] = {k: {"groups": t["groups"],
                                         "total": t["total"]}
                                     for k, t in out["tables"].items()}
                summary.append(out)
    print(json.dumps({"phase14": summary}), flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from kmer_tpu_torch.kernels import (
        codes_keys, row_sort, segment_copy, segment_counts, tile_gather,
        tile_stages, wire_keys)
    from kmer_tpu_torch.kernels.build import native_library

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t_start = t0 = time.perf_counter()
    libraries = (wire_keys, codes_keys, segment_counts, tile_gather,
                 tile_stages, row_sort, segment_copy)
    builds = [m.build for m in libraries] + [native_library]
    with ThreadPoolExecutor(len(builds)) as pool:  # one compiler each
        for future in [pool.submit(b) for b in builds]:
            future.result()
    log(f"build: {len(libraries)} kernel libraries and the host parser in "
        f"{time.perf_counter() - t0:.2f} s")
    for m in libraries:
        stem = m.__name__.rsplit(".", 1)[-1]
        log(f"ptxas, {stem}.cu: {ptxas_report(stem)}")
    for stem in ("tile_stages", "segment_copy", "tile_gather", "wire_keys",
                 "codes_keys", "row_sort"):
        check_no_spills(stem)

    t0 = time.perf_counter()
    timing = kernel_cases(dev)
    wire_timing = wire_key_cases(dev)
    codes_timing = codes_key_cases(dev)
    stream_timing = stream_key_cases(dev)
    log(f"phase 3 in {time.perf_counter() - t0:.1f} s ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        launches, main_fastq, main_table = main_path(dev, tmp)
        cov_fastq, cov_table = edge_cases(dev, tmp)
        entries = probes(dev)
        worst = probe_edges(dev)
        next(e for e in entries if e["name"] == "segment_copy")[
            "overlap_worst_case"] = worst
        bench_launches, chr_distinct, entry_want, walls = bench_on_card(
            dev, main_table.distinct(), cov_table.distinct())
        for mode, wall in walls.items():  # the phase split of the two modes
            kt = (stream_timing if mode == "chr"
                  else stream_timing["at_bench_stream"])
            eager = wall - kt["ms"] + kt["plain_ms"]  # the wall with it
            log(f"bench {mode}: wall {wall:.3f} ms, of which stream_keys "
                f"{kt['ms']:.4f} ms ({100 * kt['ms'] / wall:.2f}%, phase "
                f"3's time); the plain extraction it replaced "
                f"{kt['plain_ms']:.4f} ms, {100 * kt['plain_ms'] / eager:.2f}"
                f"% of the {eager:.3f} ms wall it makes ({card})")
        t0 = time.perf_counter()
        fold_launches, run = fold_phase(dev, tmp, main_fastq, main_table,
                                        cov_fastq, cov_table)
        log(f"phase 8: the streaming fold in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        sql_launches = sql_phase(dev, tmp, card)
        log(f"phase 9: the SQL surface in {time.perf_counter() - t0:.1f} s "
            f"({card})")
        t0 = time.perf_counter()
        engine_launches, dense_times = engine_phase(dev, tmp, main_table,
                                                    chr_distinct)
        log(f"phase 10: the one-device engine in "
            f"{time.perf_counter() - t0:.1f} s ({card})")
        print(json.dumps({"phase10_dense_vs_sort_ms": dense_times}),
              flush=True)
        t0 = time.perf_counter()
        multi_launches = multi_phase(tmp, main_fastq, main_table, run)
        log(f"phase 11: multi-device on the card in "
            f"{time.perf_counter() - t0:.1f} s ({card})")
        t0 = time.perf_counter()
        long_launches = long_runs_phase(dev, tmp, entry_want, run)
        log(f"phase 12: the long runs in {time.perf_counter() - t0:.1f} s "
            f"({card})")
    t0 = time.perf_counter()
    sort_launches, at_stage1 = sort_phase(dev)
    log(f"phase 13: the sort probes and the partition engines in "
        f"{time.perf_counter() - t0:.1f} s (budget {SORT_PHASE_BUDGET_S} s; "
        f"{card})")
    t0 = time.perf_counter()
    phase_launches = phase_probes(dev)
    log(f"phase 14: the phase probes in {time.perf_counter() - t0:.1f} s "
        f"(budget {PHASE_PROBES_BUDGET_S} s, every loop at its script's "
        f"steps; {card})")
    log(f"chip_smoke: phases 1-14 passed in "
        f"{time.perf_counter() - t_start:.1f} s")

    def by_path(name):
        return {"main path (phase 4)": launches[name],
                "bench (phase 7)": bench_launches[name],
                **{f"fold ({c})": n[name] for c, n in fold_launches.items()},
                **{f"sql ({c})": n[name] for c, n in sql_launches.items()},
                **{f"engine ({c})": n[name]
                   for c, n in engine_launches.items()},
                **{f"multi ({c})": n[name]
                   for c, n in multi_launches.items()},
                "entry (12a)": long_launches["12a"][name],
                "sustained (12b)": long_launches["12b"][name],
                "ingest (12c)": long_launches["12c"][name],
                **{path: n.get(name, 0)
                   for path, n in sort_launches.items()},
                "phases (14)": sum(n[name] for n in phase_launches.values()),
                **{path: n[name] for path, n in phase_launches.items()}}

    for entry in entries:  # the probe kernels that phase 13 launches too
        if entry["name"] in ("row_sort", "segment_copy"):
            entry["launches_by_path"] = {
                "probes (6)": entry["launches"],
                **{path: n[entry["name"]]
                   for path, n in sort_launches.items()}}
        if entry["name"] == "row_sort":
            entry["at_stage1"] = at_stage1

    main_shape = {k: v for k, v in timing["main path"].items() if k != "n"}
    print(json.dumps({"kernels": [{
        "name": "wire_keys",
        "route": "cuda",
        "source": "kmer_tpu_torch/csrc/wire_keys.cu",
        "replaces": "no pallas_call: XLA fused it on the TPU "
                    "(kmer_tpu/native.py:188, kmer_tpu/ops/extract.py:63, "
                    "133, kmer_tpu/pipeline.py:79-85)",
        "launches": launches["wire_keys"],
        "launches_by_path": by_path("wire_keys"),
        **wire_timing,
    }, {
        "name": "codes_keys",
        "route": "cuda",
        "source": "kmer_tpu_torch/csrc/codes_keys.cu",
        "replaces": "no pallas_call: XLA fused it on the TPU "
                    "(kmer_tpu/ops/extract.py:63, 133, "
                    "kmer_tpu/parallel/dist.py:57-89)",
        # this kernel's main path: the sustained stream of raw codes (12b)
        "launches": long_launches["12b"]["codes_keys"],
        "launches_by_path": by_path("codes_keys"),
        **codes_timing,
    }, {
        "name": "stream_keys",
        "route": "cuda",
        "source": "kmer_tpu_torch/csrc/wire_keys.cu",
        "replaces": "no pallas_call: XLA fused it on the TPU "
                    "(kmer_tpu/ops/extract.py:155, 133, 181, "
                    "kmer_tpu/bench.py:262, 319)",
        # this kernel's main path: the bench's stream and chr modes (7)
        "launches": bench_launches["stream_keys"],
        "launches_by_path": by_path("stream_keys"),
        **stream_timing,
    }, {
        "name": "segment_counts",
        "route": "cuda",
        "source": "kmer_tpu_torch/csrc/segment_counts.cu",
        "replaces": "kmer_tpu/pallas/segment_counts.py:58",
        "launches": launches["segment_counts"],
        "launches_by_path": by_path("segment_counts"),
        **main_shape,
        "at_fold_batch": timing["fold batch"],
    }, *entries]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
