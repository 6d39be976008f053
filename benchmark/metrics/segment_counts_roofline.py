"""Segment counts kernel (``kernels.segment_counts``,
``csrc/segment_counts.cu``): its share of the least time its bytes take
at the card's HBM peak.

Bytes of one launch, as the port's kernel table counts them: each slot's
8-byte sorted key read once and its 4-byte count written once, over the
``rows x (width - k + 1)`` slots of the batch (shapes from the wire's
upload in ``extract``).  Divided by the kernel's summed time in the
trace.  None when the launches and the batches do not pair up.
"""

KERNEL = "segment_counts_kernel"


def launch_bytes(rows: int, columns: int, k: int) -> int:
    width = (columns - 1) * 16
    return rows * max(width - k + 1, 0) * (8 + 4)


def read(run):
    kernels = run.trace.kernels(KERNEL)
    shapes = run.batch_shapes()
    if not kernels or len(shapes) != len(kernels):
        return None
    nbytes = sum(launch_bytes(r, c, run.k) for r, c in shapes)
    seconds = sum(d.end - d.ts for d in kernels) * 1e-6
    return 100.0 * nbytes / run.hbm_bytes_per_s / seconds
