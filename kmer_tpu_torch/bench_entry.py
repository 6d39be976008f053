"""The port's benchmark entry: prints ONE JSON line.

    KMER_BENCH_MODE=fused KMER_BENCH_READS=1048576 KMER_BENCH_DEVICE=cuda \\
        python -m kmer_tpu_torch.bench_entry

The counterpart of the root ``bench.py``.  ``KMER_BENCH_MODE`` picks the
workload: ``fused`` (default) and ``stream`` count canonical 21-mers of
``KMER_BENCH_READS`` (default 2^20) simulated 150 bp reads
(``bench.run_bench``, ``run_bench_stream``; BASELINE.json configs[1]),
``chr`` one ~252 Mbp sequence at k = 31 (configs[4]), ``query`` index
lookups (configs[2]) and ``pattern`` qkmer containment lookups.  The
device is ``KMER_BENCH_DEVICE`` (default ``cuda``, which raises without
a card; there is no fallback to the CPU).

Standard output is the result without its ``detail``, on one line; the
``detail`` goes to standard error as ``{"detail": {...}}``, with the
count path's kernel launches and the port's own records of its long
runs: ``sustained`` from ``SUSTAINED_torch.json`` and
``out_of_core_ingest`` from ``INGEST_torch.json`` at the repository's
root (``runs.sustained``, ``runs.ingest``).  A record that is missing is
left out; one that cannot be read raises.  The TPU records of
``kmer_tpu`` (``SUSTAINED.json``, ``INGEST_r0*.json``,
``DISTCOUNT_r05.json``) are never read: they bind nothing for the port.
"""

from __future__ import annotations

import json
import os
import sys

MODES = ("fused", "stream", "chr", "query", "pattern")
SUSTAINED_KEYS = ("value", "total_kmers", "wall_s", "checkpoint_overhead_pct",
                  "n_checkpoints", "kill_resume_verified", "distinct",
                  "device", "card")


def port_records(root: str) -> dict:
    """``detail``'s entries for the port's records under ``root``."""
    out = {}
    path = os.path.join(root, "SUSTAINED_torch.json")
    if os.path.exists(path):
        with open(path) as f:
            s = json.load(f)
        out["sustained"] = {k: s[k] for k in SUSTAINED_KEYS if k in s}
    path = os.path.join(root, "INGEST_torch.json")
    if os.path.exists(path):
        with open(path) as f:
            out["out_of_core_ingest"] = json.load(f)
    return out


def run(mode: str, n_reads: int, device) -> dict:
    """The result of ``mode`` on ``device``, ``detail`` included."""
    from . import bench

    if mode == "chr":
        return bench.run_chr_bench(device=device)
    if mode == "query":
        return bench.run_query_bench(device=device)
    if mode == "pattern":
        return bench.run_pattern_bench(device=device)
    if mode not in ("fused", "stream"):
        raise ValueError(f"KMER_BENCH_MODE {mode!r} is not one of {MODES}")
    fn = bench.run_bench_stream if mode == "stream" else bench.run_bench
    return fn(n_reads=n_reads, read_len=150, k=21, canonical=True,
              device=device)


def main() -> int:
    from .device import resolve_device
    from .kernels import launches
    from .runs.common import repo_root

    mode = os.environ.get("KMER_BENCH_MODE", "fused")
    n_reads = int(os.environ.get("KMER_BENCH_READS", 1 << 20))
    device = resolve_device(os.environ.get("KMER_BENCH_DEVICE", "cuda"))
    result = run(mode, n_reads, device)
    detail = result.pop("detail", {})
    detail["launches"] = launches()
    detail.update(port_records(repo_root()))
    print(json.dumps(result), flush=True)
    print(json.dumps({"detail": detail}), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
