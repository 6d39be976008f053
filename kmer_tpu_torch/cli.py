"""Command-line interface of the PyTorch port.

  python -m kmer_tpu_torch count --input reads.fastq -k 21 --canonical
                                 [--top 10] [--device cuda]
  python -m kmer_tpu_torch bench [--mode fused|stream|chr] [--reads N]
                                 [-k 21] [--trace DIR] [--device cuda]

The ``count`` subcommand takes ``kmer_tpu count``'s flags and prints the
same output for FASTA/FASTQ input: one ``kmer<TAB>count`` line per group
on stdout, by descending count and then ascending key, and a
``# N distinct, T total`` line on stderr.

The ``bench`` subcommand takes ``kmer_tpu bench``'s flags and prints the
one-line result JSON as the last line of stdout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np


def _infer_format(path: str) -> str:
    low = path.lower()
    if low.endswith(".gz"):
        low = low[:-3]
    if low.endswith((".fastq", ".fq")):
        return "fastq"
    if low.endswith((".fasta", ".fa", ".fna")):
        return "fasta"
    return "csv"


def _cmd_count(args) -> int:
    from .ops.wide import WideCounts
    from .packed import PackedKmers
    from .pipeline import count_file
    from .utils.logging import StatsCounters, get_logger

    log = get_logger()
    stats = StatsCounters()
    fmt = args.format or _infer_format(args.input)
    if fmt == "csv":
        raise NotImplementedError(
            "CSV input (the kmer/dna column GROUP BY) is not ported to "
            "kmer_tpu_torch yet (ROADMAP.md §1 item 8)")
    result = count_file(
        args.input, fmt, args.k, canonical=args.canonical,
        batch=args.batch or None, width=args.width or None,
        chunk_bytes=args.chunk_mb << 20 if args.chunk_mb else None,
        capacity=args.slots,
        max_capacity=args.max_slots or None,
        spill_dir=args.spill_dir,
        stats=stats,
        ckpt_path=args.ckpt,
        device=args.device,
    )
    log.info("stats %s", stats.to_json())
    # trimmed rows are in ascending key order, so a stable sort by -count
    # keeps ties key-ascending; only the printed rows are decoded
    t = result.trim()
    if isinstance(t, WideCounts):
        hi, lo, length, _, _ = t.to_numpy()
        c64 = t.counts64()
    else:
        hi, lo, length, counts = t.to_numpy()
        c64 = counts.astype(np.int64)
    order = np.argsort(-c64, kind="stable")
    if args.top:
        order = order[: args.top]
    strs = PackedKmers(hi=hi, lo=lo, length=length)[order].to_strings()
    for kmer, count in zip(strs, c64[order]):
        print(f"{kmer}\t{int(count)}")
    print(f"# {c64.size} distinct, {int(c64.sum())} total", file=sys.stderr)
    if args.save:
        meta = {"k": args.k, "canonical": args.canonical}
        if isinstance(t, WideCounts):
            from .parallel.streaming import save_wide

            save_wide(t, args.save, meta)
        else:
            from .utils.checkpoint import save_table

            save_table(t, args.save, meta)
        log.info("saved table to %s", args.save)
    return 0


def _cmd_bench(args) -> int:
    from . import bench

    if args.queries or args.mode in ("shq", "pattern"):
        raise NotImplementedError(
            "the query, pattern and shq bench modes need the index and the "
            "predicates, which are not ported yet (ROADMAP.md §1 item 8)")
    if args.no_pallas:
        raise NotImplementedError(
            "--no-pallas is not ported: on a CUDA device the count always "
            "launches the segment-count kernel (ROADMAP.md §1)")
    trace = contextlib.nullcontext()
    if args.trace:
        from torch.profiler import (
            ProfilerActivity, profile, tensorboard_trace_handler)

        activities = [ProfilerActivity.CPU]
        if args.device.startswith("cuda"):
            activities.append(ProfilerActivity.CUDA)
        trace = profile(activities=activities,
                        on_trace_ready=tensorboard_trace_handler(args.trace))
    canonical = not args.no_canonical
    with trace:
        if args.mode == "chr":
            result = bench.run_chr_bench(device=args.device)
        elif args.mode == "stream":
            result = bench.run_bench_stream(
                n_reads=args.reads, read_len=args.read_len, k=args.k,
                canonical=canonical, device=args.device)
        else:
            result = bench.run_bench(
                n_reads=args.reads, read_len=args.read_len, k=args.k,
                canonical=canonical, coverage_genome=args.coverage_genome,
                device=args.device)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmer_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("count", help="GROUP BY counts over a FASTA/FASTQ file")
    c.add_argument("--input", required=True)
    c.add_argument(
        "--format", choices=["csv", "fasta", "fastq"], default=None,
        help="input format (default: inferred from the file extension; "
        "csv is not ported yet)",
    )
    c.add_argument("-k", type=int, default=8)
    c.add_argument("--canonical", action="store_true")
    c.add_argument("--top", type=int, default=0)
    c.add_argument(
        "--batch", type=int, default=0,
        help="reads per device batch (0 = auto: ~64M window slots a batch)",
    )
    c.add_argument(
        "--width", type=int, default=0,
        help="fixed row width in bases (0 = auto from the first ingest "
        "chunk's read lengths; longer reads split exactly)",
    )
    c.add_argument("--save", default=None, help="save table snapshot (.npz)")
    c.add_argument(
        "--ckpt", default=None, metavar="PATH",
        help="resumable checkpoint path (takes the streaming fold)",
    )
    c.add_argument(
        "--chunk-mb", type=int, default=0, metavar="MB",
        help="ingest window size in MiB (default 256)",
    )
    c.add_argument(
        "--slots", type=int, default=1 << 24, metavar="N",
        help="initial accumulator slots of the streaming fold",
    )
    c.add_argument(
        "--max-slots", type=int, default=0, metavar="N",
        help="device slot budget: past it the fold spills sorted runs "
        "(takes the streaming fold)",
    )
    c.add_argument(
        "--spill-dir", default=None, metavar="DIR",
        help="directory for spilled runs (default: host memory; takes "
        "the streaming fold)",
    )
    c.add_argument(
        "--device", default="cuda",
        help="torch device to count on (default cuda; cpu runs the plain "
        "PyTorch versions of the kernels)",
    )
    c.set_defaults(fn=_cmd_count)

    b = sub.add_parser("bench", help="counting throughput benchmark (one card)")
    b.add_argument("--reads", type=int, default=1 << 20)
    b.add_argument("--read-len", type=int, default=150)
    b.add_argument("-k", type=int, default=21)
    b.add_argument("--no-canonical", action="store_true")
    b.add_argument("--no-pallas", action="store_true",
                   help="kmer_tpu's switch to its XLA segment counts; not "
                   "ported (raises)")
    b.add_argument("--mode",
                   choices=["fused", "stream", "chr", "shq", "pattern"],
                   default="fused",
                   help="shq and pattern are not ported yet (raise)")
    b.add_argument("--queries", action="store_true",
                   help="index lookups instead of counting; not ported yet "
                   "(raises)")
    b.add_argument("--trace", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the run to DIR")
    b.add_argument("--coverage-genome", type=int, default=None,
                   metavar="BASES",
                   help="sample reads from one random genome of this size "
                   "(realistic duplication) instead of uniform-random")
    b.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                   "PyTorch versions of the kernels)")
    b.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
