"""Command-line interface of the PyTorch port.

  python -m kmer_tpu_torch datagen --rows 1000 --out data.csv [--seed 0]
  python -m kmer_tpu_torch count   --input data.csv|reads.fastq|ref.fasta -k 8
                                   [--canonical] [--top 10]
                                   [--from-dna-column] [--device cuda]
  python -m kmer_tpu_torch extract --dna ACGTACGT -k 3
  python -m kmer_tpu_torch query   --input data.csv [--index]
                                   --eq acga | --prefix ac | --pattern angry
                                   [--device cuda]
  python -m kmer_tpu_torch parity  [--scale 100000] [--device cuda]
  python -m kmer_tpu_torch bench   [--mode fused|stream|chr|pattern]
                                   [--queries] [--reads N] [-k 21]
                                   [--trace DIR] [--device cuda]

Each subcommand takes ``kmer_tpu``'s flags and prints the same output;
those that touch a device also take ``--device`` (default cuda, which
raises without a card).  ``count`` prints one ``kmer<TAB>count`` line per
group on stdout, by descending count and then ascending key, and a
``# N distinct, T total`` line on stderr; on a CSV it groups the kmer
column, or with ``--from-dna-column`` counts the k-mers of the dna
column.  ``query`` prints the matching rows as CSV and ``# N rows`` on
stderr.  ``bench`` prints the one-line result JSON as the last line of
stdout.  ``extract`` and ``datagen`` run on the host.
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


def _cmd_datagen(args) -> int:
    from .io.datagen import generate_test_rows, rows_to_csv

    rows = generate_test_rows(args.rows, seed=args.seed)
    rows_to_csv(rows, args.out)
    print(f"wrote {len(rows)} rows to {args.out}")
    return 0


def _cmd_extract(args) -> int:
    from .ops.extract import generate_kmers

    for km in generate_kmers(args.dna, args.k):
        print(str(km))
    return 0


def _cmd_count(args) -> int:
    from .api import KmerTable
    from .ops.wide import WideCounts
    from .packed import PackedKmers
    from .pipeline import (
        column_batch_feed,
        count_batches_pipelined,
        count_file,
        initial_capacity,
    )
    from .utils.logging import StatsCounters, get_logger

    log = get_logger()
    stats = StatsCounters()
    fmt = args.format or _infer_format(args.input)
    if fmt in ("fasta", "fastq"):
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
    elif args.from_dna_column:
        table = KmerTable.from_csv(args.input, device=args.device)
        seqs = [str(d) for d in table.dna]
        feed, _, _ = column_batch_feed(seqs, args.k, batch=args.batch or None,
                                       width=args.width or None)
        cap = initial_capacity(args.slots, args.k, sum(len(s) for s in seqs))
        if args.max_slots:
            cap = min(cap, args.max_slots)
        result = count_batches_pipelined(
            feed, args.k, canonical=args.canonical, stats=stats,
            capacity=cap, max_capacity=args.max_slots or None,
            spill_dir=args.spill_dir, device=args.device)
    else:
        table = KmerTable.from_csv(args.input, device=args.device)
        result = table.group_by_kmer()
        stats.record_batch(len(table), 0, result.total(), result.distinct())
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


def _cmd_query(args) -> int:
    from .api import KmerTable

    table = KmerTable.from_csv(args.input, device=args.device)
    if args.index:
        table.create_index()
    if args.eq is not None:
        ids = table.where_eq(args.eq)
    elif args.prefix is not None:
        ids = table.where_prefix(args.prefix)
    elif args.pattern is not None:
        ids = table.where_pattern(args.pattern)
    else:
        print("one of --eq/--prefix/--pattern required", file=sys.stderr)
        return 2
    for row in table.rows(ids):
        print(",".join(row))
    print(f"# {len(ids)} rows", file=sys.stderr)
    return 0


def _cmd_parity(args) -> int:
    from .parity import run_parity, run_scale_parity

    ok = run_parity(device=args.device)
    if args.scale:
        ok = run_scale_parity(n_rows=args.scale, device=args.device) and ok
    return 0 if ok else 1


def _cmd_bench(args) -> int:
    from . import bench

    if args.mode == "shq" and not args.queries:
        raise NotImplementedError(
            "the shq bench mode (sharded index serving) comes with the "
            "multi-device port (ROADMAP.md §1 item 6)")
    if args.no_pallas:
        raise NotImplementedError(
            "--no-pallas (kmer_tpu's EngineConfig.use_pallas) is not "
            "ported: on a CUDA device the count always launches the "
            "segment-count kernel (ROADMAP.md §1 item 2, config)")
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
        if args.queries:
            result = bench.run_query_bench(device=args.device)
        elif args.mode == "pattern":
            result = bench.run_pattern_bench(device=args.device)
        elif args.mode == "chr":
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


def _device_flag(parser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda, which raises without a card; cpu "
        "runs the plain PyTorch versions of the kernels)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmer_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("datagen", help="generate random test rows "
                       "(data_generator.py shape)")
    g.add_argument("--rows", type=int, default=1000)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--out", required=True)
    g.set_defaults(fn=_cmd_datagen)

    e = sub.add_parser("extract", help="generate_kmers over a dna literal")
    e.add_argument("--dna", required=True)
    e.add_argument("-k", type=int, required=True)
    e.set_defaults(fn=_cmd_extract)

    c = sub.add_parser("count",
                       help="GROUP BY counts over a CSV/FASTA/FASTQ file")
    c.add_argument("--input", required=True)
    c.add_argument(
        "--format", choices=["csv", "fasta", "fastq"], default=None,
        help="input format (default: inferred from the file extension)",
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
        "--from-dna-column", action="store_true",
        help="CSV: count the k-mers of the dna column instead of grouping "
        "the kmer column",
    )
    _device_flag(c)
    c.set_defaults(fn=_cmd_count)

    q = sub.add_parser("query", help="filter rows by kmer predicate")
    q.add_argument("--input", required=True)
    q.add_argument("--index", action="store_true",
                   help="build + use the sorted index")
    q.add_argument("--eq")
    q.add_argument("--prefix")
    q.add_argument("--pattern")
    _device_flag(q)
    q.set_defaults(fn=_cmd_query)

    pr = sub.add_parser("parity", help="run the reference-suite parity checks")
    pr.add_argument("--scale", type=int, default=0, metavar="N",
                    help="also run the N-row scale parity (scan == index == "
                    "oracle, GROUP BY oracle; 100000 is the reference "
                    "suite's size)")
    _device_flag(pr)
    pr.set_defaults(fn=_cmd_parity)

    b = sub.add_parser("bench", help="throughput benchmark (one card)")
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
                   help="pattern: qkmer containment lookups; shq is not "
                   "ported yet (raises)")
    b.add_argument("--queries", action="store_true",
                   help="benchmark index lookups instead of counting")
    b.add_argument("--trace", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the run to DIR")
    b.add_argument("--coverage-genome", type=int, default=None,
                   metavar="BASES",
                   help="sample reads from one random genome of this size "
                   "(realistic duplication) instead of uniform-random")
    _device_flag(b)
    b.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    if getattr(args, "device", None) is not None:
        from .device import resolve_device

        resolve_device(args.device)  # raise before any input is read
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
