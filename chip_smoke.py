#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``kmer_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits nonzero:

1. device: a CUDA card is required; prints its name and power limit;
2. build: compiles the kernels (nvcc) and the host parser (cc) from the
   sources in this checkout;
3. kernel vs plain: the segment-count kernel must equal its plain PyTorch
   version exactly on the cases of tests/test_pallas.py and at the main
   path's shape (~147M sorted keys); prints both times;
4. main path: writes a FASTQ of 1,000,000 x 150 bp reads from a seed and
   counts it (k = 21, canonical) through ``count_file`` on the card; the
   kernel's launch count must rise, and the table must equal an
   independent numpy oracle exactly;
5. coverage reads and variable-length reads at k = 32 (with all-t reads)
   and k = 31, each exact against the oracle.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it is the card's name and power limit, and the one before that the
kernels' JSON record.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

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


def write_fastq(path: str, reads: list[np.ndarray] | np.ndarray) -> None:
    """FASTQ of 2-bit code reads; fixed-length reads are written in bulk."""
    letters = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        if isinstance(reads, np.ndarray):
            n, length = reads.shape
            head = 9  # "@r" + 7 digits
            rec = np.empty((n, head + 1 + length + 3 + length + 1), np.uint8)
            rec[:, 0], rec[:, 1] = ord("@"), ord("r")
            idx = np.arange(n)
            for d in range(7):
                rec[:, 2 + d] = ord("0") + (idx // 10 ** (6 - d)) % 10
            rec[:, head] = ord("\n")
            rec[:, head + 1: head + 1 + length] = letters[reads]
            q = head + 1 + length
            rec[:, q: q + 3] = np.frombuffer(b"\n+\n", np.uint8)
            rec[:, q + 3: q + 3 + length] = ord("I")
            rec[:, -1] = ord("\n")
            f.write(rec.tobytes())
            return
        for i, r in enumerate(reads):
            seq = letters[r].tobytes()
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
    hi, lo, length, counts = table.trim().to_numpy()
    got = key_from_hi_lo(hi, lo).view(np.uint64)
    check(np.array_equal(got, want), f"{what}: keys equal the oracle's")
    check(np.array_equal(counts, want_counts), f"{what}: counts equal")
    check(bool((length == k).all()), f"{what}: every length is k")
    check(table.distinct() == want.size, f"{what}: n_unique")


# --- phases --------------------------------------------------------------


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


def kernel_cases(dev) -> dict:
    """Kernel == plain version, exactly, on every case; times at the
    main path's shape."""
    import torch

    from kmer_tpu_torch.kernels.segment_counts import (
        segment_counts, segment_counts_reference)
    from kmer_tpu_torch.ops.count import SENTINEL_KEY
    from kmer_tpu_torch.packed import SIGN_FLIP, as_int64, key_from_hi_lo

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

    rng = np.random.default_rng(SEED)
    u32 = np.uint32
    cases = [
        ("random with duplicates",
         rng.integers(0, 7, 5000).astype(u32),
         rng.integers(0, 5, 5000).astype(u32), None),
        ("one segment spanning every tile",
         np.r_[np.zeros(5 * 4096 + 7, u32), u32(9)],
         np.zeros(5 * 4096 + 8, u32), None),
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

    # the main path's shape: 2 batches x 524,288 rows x 140 slots, of which
    # ~17M are invalid (sentinel); valid keys left-aligned 21-mers drawn
    # from 2^27 values, so segments of 1 to ~10 equal keys
    n, n_sent = 2 * 524288 * 140, 2 * 524288 * 16
    keys = rng.integers(0, 1 << 27, n, dtype=np.int64) << 22
    keys[-n_sent:] = SENTINEL_KEY
    flipped = torch.from_numpy(keys).to(dev) ^ SIGN_FLIP
    sort_ms = time_cuda(lambda: torch.sort(flipped), 3)
    skeys = torch.sort(flipped).values
    del flipped
    sentinel = SENTINEL_KEY ^ SIGN_FLIP
    err = compare(skeys, sentinel, "main-path shape")
    ms = time_cuda(lambda: segment_counts(skeys, sentinel), 20)
    plain_ms = time_cuda(lambda: segment_counts_reference(skeys, sentinel), 5)
    log(f"main-path shape n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.sort {sort_ms:.4f} ms")
    return {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms}


def main_path(dev, tmp: str) -> int:
    """Counts the 1M x 150 bp FASTQ on the card; returns kernel launches."""
    import torch

    from kmer_tpu_torch.kernels.segment_counts import segment_counts
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
    segment_counts.launches = 0
    t0 = time.perf_counter()
    table = count_file(path, "fastq", K, canonical=True, device=dev)
    torch.cuda.synchronize(dev)
    t_count = time.perf_counter() - t0
    launches = segment_counts.launches
    host = table.trim()
    wall = time.perf_counter() - t0
    check(launches > 0, "the main path launched the segment-count kernel")
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
    return launches


def edge_cases(dev, tmp: str) -> None:
    from kmer_tpu_torch.ops.extract import simulate_coverage_reads
    from kmer_tpu_torch.pipeline import count_file

    reads = simulate_coverage_reads(200_000, READ_LEN, 1_000_000, seed=SEED)
    path = os.path.join(tmp, "coverage.fastq")
    write_fastq(path, reads)
    table = count_file(path, "fastq", K, canonical=True, device=dev)
    check_table(table, oracle_keys(reads, K, canonical=True), K, "coverage")
    log(f"coverage reads: exact; distinct {table.distinct()}, total "
        f"{table.total()}")

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from kmer_tpu_torch.kernels.build import native_library
    from kmer_tpu_torch.kernels.segment_counts import build

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    build()
    native_library()
    log(f"build: kernels and host parser in {time.perf_counter() - t0:.2f} s")

    timing = kernel_cases(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = main_path(dev, tmp)
        edge_cases(dev, tmp)

    print(json.dumps({"kernels": [{
        "name": "segment_counts",
        "route": "cuda",
        "source": "kmer_tpu_torch/csrc/segment_counts.cu",
        "replaces": "kmer_tpu/pallas/segment_counts.py:58",
        "launches": launches,
        **timing,
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
