"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed one step below the
configuration's guarantee, its keys cut to their top 32 bits (as a table
keyed on a 32-bit word would hold them).  The comparison has to find it
wrong; this prints its readings beside the program's limit.

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...]

Runs on the host alone, at the cell's own size; the benchmark's runs do
not run it.
"""

from __future__ import annotations

import argparse
import sys
import time

from .harness import mismatched_rows
from .reference import kmers
from .spec import Spec

KEY_BITS = 32


def readings(workload: str, seed: int, spec: Spec | None = None,
             config: dict | None = None) -> dict:
    """The numbers the harness compares, for the control in the program's
    place on ``seed`` (``config`` updates the cell's, for a test size)."""
    import numpy as np

    spec = spec or Spec()
    cell = spec.workload(workload)
    cfg = {**spec.config(cell), **(config or {})}
    data = spec.module("gen", cfg["generator"]).sample(cfg, seed)
    ref = spec.module("reference", cfg["reference"])
    keys, counts = ref.table(data)
    c_keys, c_counts = kmers.truncate(keys, counts, KEY_BITS)
    hi = (c_keys >> np.uint64(32)).astype(np.uint32)
    lo = (c_keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    lanes = (hi, lo, np.full(c_keys.size, cfg["k"], np.int32),
             (c_counts >> 32).astype(np.int32),
             (c_counts & 0xFFFFFFFF).astype(np.uint32))
    return {"mismatched_rows": mismatched_rows(keys, counts, lanes, cfg["k"]),
            "row_count_gap": abs(int(c_keys.size) - int(keys.size))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t = time.perf_counter()
        got = readings(args.workload, seed)
        print(f"control {args.workload} seed {seed}: "
              + ", ".join(f"{k} {v} (limit 0)" for k, v in got.items())
              + f"; {time.perf_counter() - t:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
