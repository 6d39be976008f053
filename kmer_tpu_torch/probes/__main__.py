"""python -m kmer_tpu_torch.probes [--only FAMILY] [--device cuda] [--small]

Runs the ported probes (FAMILY: capability, rates, copies, sorting,
partition, matmul, or a phase probe: feed, device_phases, count_phases,
read_stream, fold_step, stream_loop, checkpoint, distcount_step; all by
default) and exits 1 if any probe is not correct.
"""

from __future__ import annotations

import argparse
import sys

from . import FAMILIES, run_all


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kmer_tpu_torch.probes",
                                description=__doc__)
    p.add_argument("--only", choices=sorted(FAMILIES), default=None,
                   help="run one family of probes")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                   "PyTorch versions of the kernels)")
    p.add_argument("--small", action="store_true",
                   help="fewer tiles, chained launches, copies and keys "
                   "(never a tile's or a row sort's width), and the phase "
                   "probes' small workloads, for a quick run on the CPU")
    args = p.parse_args(argv)
    records = run_all(args.device, only=args.only, small=args.small)
    bad = [r.name for r in records if not r.correct]
    if bad:
        print(f"not correct: {', '.join(bad)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
