"""Command-line interface of the PyTorch port.

  python -m kmer_tpu_torch datagen --rows 1000 --out data.csv [--seed 0]
  python -m kmer_tpu_torch count   --input data.csv|reads.fastq|ref.fasta -k 8
                                   [--canonical] [--top 10]
                                   [--from-dna-column] [--trace DIR]
                                   [--n-policy skip|break] [--device cuda]
  python -m kmer_tpu_torch extract --dna ACGTACGT -k 3
  python -m kmer_tpu_torch query   --input data.csv [--index]
                                   --eq acga | --prefix ac | --pattern angry
                                   [--device cuda]
  python -m kmer_tpu_torch parity  [--scale 100000] [--device cuda]
  python -m kmer_tpu_torch bench   [--mode fused|stream|chr|shq|pattern]
                                   [--queries] [--reads N] [-k 21]
                                   [--trace DIR] [--device cuda]
  python -m kmer_tpu_torch distcount --input shard.fastq -k 21
                                   [--coordinator HOST:PORT
                                    --num-processes N --process-id I
                                    --backend nccl|gloo] [--ckpt STEM]
                                   [--out STEM] [--device cuda]
  python -m kmer_tpu_torch serve   --input data.csv [--no-index]
                                   [--wal PATH] [--tcp PORT] [--device cuda]
  python -m kmer_tpu_torch selftest [--device cuda]

Each subcommand takes ``kmer_tpu``'s flags and prints the same output;
those that touch a device also take ``--device`` (default cuda, which
raises without a card).  ``serve`` answers one JSON line a command (see
``_cmd_serve``).  ``count`` prints one ``kmer<TAB>count`` line per
group on stdout, by descending count and then ascending key, and a
``# N distinct, T total`` line on stderr; on a CSV it groups the kmer
column, or with ``--from-dna-column`` counts the k-mers of the dna
column; on FASTA/FASTQ ``--n-policy break`` (``kmer_tpu`` has no such
flag) ends a contig at each non-ACGT run instead of joining its flanks.
``query`` prints the matching rows as CSV and ``# N rows`` on
stderr.  ``bench`` prints the one-line result JSON as the last line of
stdout.  ``distcount`` (one process per rank) prints one JSON line
per rank (``kmer_tpu``'s keys, and a ``detail`` with the rank's rate,
merge efficiency, peak device memory and kernel launches) and exits 3 on
overflow.  ``extract`` and ``datagen`` run on the
host.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

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
    if args.trace:
        return _traced_count(args)
    from .api import KmerTable
    from .ops.wide import wide_from_table
    from .packed import PackedKmers, hi_lo_from_key
    from .parallel.streaming import save_wide
    from .pipeline import (
        column_batch_feed,
        count_batches_pipelined,
        count_file,
        initial_capacity,
    )
    from .kernels import launches
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
            n_policy=args.n_policy,
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
        result = wide_from_table(table.group_by_kmer())
        stats.record_batch(len(table), 0, result.total(), result.distinct())
    log.info("stats %s", stats.to_json())
    log.info("launches %s", json.dumps(launches()))
    keys, length, c64, distinct, total = _printed_rows(result, args.top)
    hi, lo = hi_lo_from_key(keys)
    strs = PackedKmers(hi=hi, lo=lo, length=length).to_strings()
    for kmer, count in zip(strs, c64):
        print(f"{kmer}\t{int(count)}")
    print(f"# {distinct} distinct, {total} total", file=sys.stderr)
    if args.save:
        meta = {"k": args.k, "canonical": args.canonical}
        save_wide(result.trim(), args.save, meta)
        log.info("saved table to %s", args.save)
    return 0


def _traced_count(args) -> int:
    """``count`` under a ``torch.profiler``, its Chrome trace written to
    ``args.trace`` with the feeder thread's spans merged in on the trace's
    clock (``utils.profiling.write_trace``)."""
    from torch.profiler import ProfilerActivity, profile

    from .utils import profiling

    activities = [ProfilerActivity.CPU]
    if args.device.startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        rc = _cmd_count(argparse.Namespace(**{**vars(args), "trace": None}))
    os.makedirs(args.trace, exist_ok=True)
    path = os.path.join(args.trace, f"count.{os.getpid()}.pt.trace.json")
    profiling.write_trace(prof, path)
    print(f"# trace written to {path}", file=sys.stderr)
    return rc


def _printed_rows(result, top: int):
    """(keys, lengths, 64-bit counts) of the rows ``count`` prints, as
    numpy, by descending count and then ascending key, and the table's
    (distinct, total).  Live rows sit in ascending key order, so a stable
    sort by -count keeps ties key-ascending; it runs on the result's
    device, and with ``top`` only the printed rows come to the host."""
    import torch

    live = torch.nonzero(result.counts > 0).squeeze(1)
    counts = result.counts[live].to(torch.int64)
    order = torch.sort(-counts, stable=True).indices
    if top:
        order = order[:top]
    rows = live[order]
    return (result.keys[rows].cpu().numpy(),
            result.length[rows].cpu().numpy().astype(np.int32),
            counts[order].cpu().numpy(), int(live.numel()),
            int(counts.sum()))


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


def _replay_wal(table, path: str) -> tuple[int, int]:
    """Re-apply acknowledged mutations from a write-ahead log written by
    either package.

    A torn final line (kill mid-write) stops the replay: a mutation is
    acknowledged only after its fsynced log entry, so a torn line was
    never acknowledged and dropping it is correct.  Returns (mutations
    replayed, byte offset past the last good entry); the caller truncates
    the file there before appending, or the next entry would join the
    torn line and end every later replay at it.
    """
    n = 0
    good_end = 0
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode("utf-8", "replace").strip()
            if not line:
                good_end += len(raw)
                continue
            if not raw.endswith(b"\n"):
                break  # torn final line (no newline: its fsync never ran)
            try:
                e = json.loads(line)
            except json.JSONDecodeError:
                break
            op = e.get("op")
            if op == "insert":
                table.insert_rows([tuple(e["row"])])
            elif op == "delete_kmer":
                table.delete_where_kmer_eq(e["q"])
            elif op == "delete_dna":
                table.delete_where_dna_eq(e["q"])
            n += 1
            good_end += len(raw)
    return n, good_end


class _Wal:
    """The serve write-ahead log: ``append`` writes one JSON line and
    fsyncs it.  A failed append truncates the file back to where it
    began, so no partial line is left for the next entry to join."""

    def __init__(self, path: str):
        self._f = open(path, "ab")

    def append(self, entry: dict) -> None:
        start = self._f.tell()
        try:
            self._f.write((json.dumps(entry) + "\n").encode())
            self._f.flush()
            os.fsync(self._f.fileno())
        except BaseException:
            try:
                self._f.truncate(start)
            except OSError:
                pass
            raise

    def close(self) -> None:
        self._f.close()


def _cmd_serve(args) -> int:
    """Resident query server over a loaded table (``kmer_tpu``'s ``serve``).

    Loads the CSV once on ``--device``, builds the index once (unless
    ``--no-index``), then answers one command a line from stdin, or from
    many clients with ``--tcp PORT``:

        EQ <kmer> | PREFIX <kmer> | PATTERN <qkmer> | COUNT | DISTINCT
        | GROUP <n>  (top-n kmer counts)
        | INSERT <dna>,<kmer>,<qkmer>  (validating; bad rows insert nothing)
        | DELETE <kmer>      (DELETE WHERE kmer = x)
        | DELETEDNA <dna>    (DELETE WHERE dna = x, kmer-test.sql:26)
        | QUIT

    Each answer is one JSON line, byte for byte ``kmer_tpu``'s.  With
    ``--wal PATH`` a mutation is validated, then its log entry is written
    and fsynced, then it is applied and acknowledged; a restarted server
    replays the log (``kmer_tpu``'s WAL format, so either package replays
    the other's).  ``--tcp`` serves each connection on its own thread,
    every command under one table lock; the ready line carries the port.
    """
    from .api import KmerTable
    from .utils.logging import get_logger

    log = get_logger()
    table = KmerTable.from_csv(args.input, device=args.device)
    wal = None
    if args.wal:
        if os.path.exists(args.wal):
            n, good_end = _replay_wal(table, args.wal)
            if good_end < os.path.getsize(args.wal):
                # drop the torn (never acknowledged) tail before appending
                with open(args.wal, "r+b") as tf:
                    tf.truncate(good_end)
                log.info("truncated torn WAL tail at byte %d", good_end)
            log.info("replayed %d WAL mutations from %s", n, args.wal)
        wal = _Wal(args.wal)
    try:
        if not args.no_index:
            table.create_index()
        log.info("serving %d rows from %s (index=%s, device=%s)", len(table),
                 args.input, not args.no_index, table.device)
        execute = _make_serve_executor(
            table, wal.append if wal is not None else None)
        if args.tcp is not None:
            _serve_tcp(execute, len(table), args.tcp)
            return 0
        print(json.dumps({"ready": len(table)}), flush=True)
        for line in sys.stdin:
            r = execute(line)
            if r == "QUIT":
                break
            if r is not None:
                print(json.dumps(r), flush=True)
        return 0
    finally:
        if wal is not None:
            wal.close()


def _serve_tcp(execute, n_rows: int, port: int) -> None:
    """Thread-per-connection serving on 127.0.0.1:``port`` (0: a free
    port, named in the ready line) until interrupted."""
    import socketserver

    class _Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for raw in self.rfile:
                r = execute(raw.decode("utf-8", "replace"))
                if r == "QUIT":
                    break
                if r is None:
                    continue
                self.wfile.write((json.dumps(r) + "\n").encode())
                self.wfile.flush()

    class _Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with _Server(("127.0.0.1", port), _Handler) as srv:
        print(json.dumps({"ready": n_rows, "tcp": srv.server_address[1]}),
              flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass


def _make_serve_executor(table, durable=None):
    """One-command executor shared by the stdin and TCP servers.

    Every command runs under one lock (KmerTable mutation is not
    thread-safe, and a mutation must be atomic with its log entry), with
    the table's device current, so a handler thread works on the table's
    card whatever its own current device.  A mutation is write-ahead:
    validated (INSERT parses its row; DELETE and DELETEDNA find their
    rows), then ``durable(entry)`` logs it, then it is applied.  If the
    log write raises, the answer is the error and the table is unchanged.
    """
    import threading

    import torch

    lock = threading.RLock()
    state = {"group": None}

    def on_device():
        if table.device.type == "cuda":
            return torch.cuda.device(table.device)
        return contextlib.nullcontext()

    def mutate(entry: dict, apply) -> int:
        if durable is not None:
            durable(entry)
        state["group"] = None  # aggregates are stale
        return apply()

    def execute(line: str):
        parts = line.strip().split(None, 1)
        if not parts:
            return None
        cmd = parts[0].upper()
        arg = parts[1] if len(parts) > 1 else ""
        if cmd == "QUIT":
            return "QUIT"
        try:
            with lock, on_device():
                if cmd == "EQ":
                    return {"rows": [int(i) for i in table.where_eq(arg)]}
                elif cmd == "PREFIX":
                    return {"rows": [int(i) for i in table.where_prefix(arg)]}
                elif cmd == "PATTERN":
                    return {"rows": [int(i)
                                     for i in table.where_pattern(arg)]}
                elif cmd == "COUNT":
                    return {"value": table.count()}
                elif cmd == "DISTINCT":
                    return {"value": table.distinct_kmers()}
                elif cmd == "INSERT":
                    parts3 = arg.split(",")
                    if len(parts3) != 3:
                        return {"error": "INSERT expects dna,kmer,qkmer"}
                    row = tuple(p.strip() for p in parts3)
                    parsed = table.parse_rows([row])
                    return {"inserted": mutate(
                        {"op": "insert", "row": list(row)},
                        lambda: table.append_rows(parsed))}
                elif cmd == "DELETE":
                    ids = table.where_eq(arg.strip())
                    return {"deleted": mutate(
                        {"op": "delete_kmer", "q": arg.strip()},
                        lambda: table.delete_ids(ids))}
                elif cmd == "DELETEDNA":
                    ids = table.where_dna_eq(arg.strip())
                    return {"deleted": mutate(
                        {"op": "delete_dna", "q": arg.strip()},
                        lambda: table.delete_ids(ids))}
                elif cmd == "GROUP":
                    if state["group"] is None:
                        state["group"] = sorted(
                            table.group_by_kmer().to_dict().items(),
                            key=lambda kv: (-kv[1], kv[0]),
                        )
                    return {"groups": state["group"][: int(arg or 10)]}
                else:
                    return {"error": f"unknown command {cmd!r}"}
        except Exception as e:  # bad literals etc. must not kill the server
            return {"error": str(e)}

    return execute


def _cmd_selftest(args) -> int:
    """Quick end-to-end smoke of every subsystem on small data, on
    ``--device`` (``kmer_tpu``'s checks)."""
    from . import (
        KmerIndex,
        PackedKmers,
        contains,
        count_dna,
        equals,
        generate_kmers,
        starts_with_op,
    )

    def check(cond: bool, what: str) -> None:
        if not cond:
            raise RuntimeError(f"selftest failed: {what}")

    t0 = time.time()
    check([str(k) for k in generate_kmers("ACGTACGT", 3)] == [
        "acg", "cgt", "gta", "tac", "acg", "cgt"], "generate_kmers")
    check(count_dna("ACGTACGT", 4, device=args.device).to_dict() == {
        "acgt": 2, "cgta": 1, "gtac": 1, "tacg": 1}, "count_dna")
    check(equals("ACGT", "acgt") and starts_with_op("acgt", "ac"),
          "equals, starts_with")
    check(contains("RCGT", "ACGT") and not contains("U", "A"), "contains")
    idx = KmerIndex.build(PackedKmers.from_strings(["acga", "acgt", "acga"]))
    check(idx.search_eq("acga").tolist() == [0, 2], "KmerIndex.search_eq")
    print(f"selftest ok in {time.time() - t0:.2f}s")
    return 0


def _cmd_bench(args) -> int:
    from . import bench

    from .config import EngineConfig

    EngineConfig(k=args.k, canonical=not args.no_canonical,
                 read_len=args.read_len,
                 use_pallas=not args.no_pallas).activate()
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
        elif args.mode == "shq":
            result = bench.run_sharded_query_bench(device=args.device)
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


def _cmd_distcount(args) -> int:
    """Distributed streaming count: one process per rank, each with the
    same coordinator and its own input shard; rank i writes its disjoint
    hash range to <out>.rank{i}.npz (merge them with
    ``parallel.driver.merge_rank_files``)."""
    from .parallel.driver import run_distcount
    from .utils.logging import StatsCounters, get_logger

    stats = StatsCounters()
    local, overflow = run_distcount(
        input_path=args.input, k=args.k, fmt=args.format,
        canonical=args.canonical, coordinator=args.coordinator,
        num_processes=args.num_processes, process_id=args.process_id,
        batch=args.batch, width=args.width, acc_capacity=args.acc_capacity,
        ckpt=args.ckpt, ckpt_every=args.ckpt_every, out=args.out,
        stats=stats,
        chunk_bytes=args.chunk_mb << 20 if args.chunk_mb else None,
        spill_dir=args.spill_dir, spill_threshold=args.spill_threshold,
        device=args.device, backend=args.backend)
    get_logger().info("stats %s", stats.to_json())
    import torch
    import torch.distributed as dist

    from .parallel.comm import STAGED
    from .kernels import launches

    dev = torch.device(args.device)
    print(json.dumps({  # ``local`` holds its live rows alone
        "rank": dist.get_rank() if dist.is_initialized() else 0,
        "local_groups": int(local.counts.numel()),
        "local_total": int(local.counts.sum()),
        "overflow": overflow,
        "detail": {
            "kmers_per_s": stats.rates()["kmers_per_s"],
            "elapsed_s": stats.elapsed,
            "merge_efficiency": stats.merge_efficiency,
            "peak_device_bytes": (torch.cuda.max_memory_allocated()
                                  if dev.type == "cuda" else None),
            "launches": launches(),
            "staged_collectives": sorted(STAGED),
        },
    }), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0 if overflow == 0 else 3


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
        "--n-policy", choices=["skip", "break"], default="skip",
        help="FASTA/FASTQ: what a non-ACGT base does. skip (default, "
        "kmer_tpu's) drops it and joins its flanks; break ends the contig "
        "there, so no window spans it (as jellyfish, meryl and KMC count)",
    )
    c.add_argument(
        "--from-dna-column", action="store_true",
        help="CSV: count the k-mers of the dna column instead of grouping "
        "the kmer column",
    )
    c.add_argument(
        "--trace", metavar="DIR", default=None,
        help="write a torch.profiler trace of the count to DIR, with the "
        "feeder thread's spans on the trace's clock",
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
                   help="pattern: qkmer containment lookups; shq: sharded "
                   "index lookups over the process group's ranks (one "
                   "rank in one process)")
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

    dc = sub.add_parser(
        "distcount",
        help="multi-host distributed streaming count (one process per rank)",
    )
    dc.add_argument("--input", required=True,
                    help="this rank's FASTA/FASTQ shard")
    dc.add_argument("--format", choices=["fasta", "fastq"], default=None)
    dc.add_argument("-k", type=int, default=21)
    dc.add_argument("--canonical", action="store_true")
    dc.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    dc.add_argument("--num-processes", type=int, default=None)
    dc.add_argument("--process-id", type=int, default=None)
    dc.add_argument("--batch", type=int, default=0,
                    help="per-rank reads per step (0 = auto-sized to ~64M "
                    "window slots when single-process, 65536 multi-process: "
                    "ranks must agree on shapes)")
    dc.add_argument("--width", type=int, default=0,
                    help="fixed row width; longer reads split exactly (0 = "
                    "auto from observed read lengths when single-process, "
                    "256 multi-process)")
    dc.add_argument("--acc-capacity", type=int, default=1 << 22,
                    help="per-rank accumulator slots (overflow is reported; "
                    "raise this or use --spill-dir for higher cardinality)")
    dc.add_argument("--chunk-mb", type=int, default=0, metavar="MB",
                    help="ingest window size in MiB (default 256)")
    dc.add_argument("--ckpt", default=None, help="checkpoint path stem")
    dc.add_argument("--ckpt-every", type=int, default=16)
    dc.add_argument(
        "--spill-dir", default=None, metavar="DIR",
        help="flush live slots to sorted runs under DIR when a shard nears "
        "capacity; the result is their exact K-way merge (requires --ckpt)")
    dc.add_argument(
        "--spill-threshold", type=float, default=0.85, metavar="F",
        help="spill when live slots exceed this fraction of capacity; leave "
        "headroom for one checkpoint interval of new keys")
    dc.add_argument("--out", default=None,
                    help="result path stem (.rank{i}.npz)")
    dc.add_argument(
        "--backend", choices=["nccl", "gloo"], default=None,
        help="process-group backend, required with a coordinator: nccl "
        "(one card per rank) or gloo (the CPU, or ranks sharing a card)")
    _device_flag(dc)
    dc.set_defaults(fn=_cmd_distcount)

    s = sub.add_parser("selftest", help="end-to-end smoke test")
    _device_flag(s)
    s.set_defaults(fn=_cmd_selftest)

    sv = sub.add_parser("serve", help="resident query server over stdin")
    sv.add_argument("--input", required=True, help="CSV table to serve")
    sv.add_argument("--no-index", action="store_true",
                    help="serve via seq scans instead of the sorted index")
    sv.add_argument(
        "--wal", default=None, metavar="PATH",
        help="write-ahead log: each mutation is logged and fsynced before "
        "it is applied and acknowledged, and replayed on restart, so a "
        "killed server loses no acknowledged INSERT/DELETE",
    )
    sv.add_argument(
        "--tcp", type=int, default=None, metavar="PORT",
        help="serve many concurrent clients over TCP on 127.0.0.1:PORT "
        "(0 = a free port, printed in the ready line) instead of the "
        "single-client stdin loop",
    )
    _device_flag(sv)
    sv.set_defaults(fn=_cmd_serve)

    args = p.parse_args(argv)
    if getattr(args, "device", None) is not None:
        from .device import resolve_device

        resolve_device(args.device)  # raise before any input is read
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
