"""Key sort (``ops.count.count_windows`` -> ``torch.sort``): the share of
the least time its bytes take at the card's HBM peak.

The sort kernels are those launched in the fold's ``count`` range whose
name holds "sort" (any case).  Bytes of one batch: each 8-byte key of the
``rows x (width - k + 1)`` slots read once and written once (shapes from
the wire's upload in ``extract``).  Divided by those kernels' summed time.
"""


def launch_bytes(rows: int, columns: int, k: int) -> int:
    width = (columns - 1) * 16
    return rows * max(width - k + 1, 0) * (8 + 8)


def read(run):
    kernels = [d for d in run.trace.launched_in(("count",))
               if d.cat == "kernel" and "sort" in d.name.lower()]
    shapes = run.batch_shapes()
    if not kernels or len(shapes) != len(run.trace.named("count")):
        return None
    nbytes = sum(launch_bytes(r, c, run.k) for r, c in shapes)
    seconds = sum(d.end - d.ts for d in kernels) * 1e-6
    return 100.0 * nbytes / run.hbm_bytes_per_s / seconds
