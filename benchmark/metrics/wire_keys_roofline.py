"""wire -> keys kernel (``kernels.wire_keys``, ``csrc/wire_keys.cu``):
its share of the least time its bytes take at the card's HBM peak.

Bytes of one launch, from the batch's shape (the wire's upload in the
fold's ``extract`` range gives rows and columns): the wire read once,
and for every slot of ``rows x (width - k + 1)`` an 8-byte key and a
1-byte valid flag written once.  Divided by the kernel's summed time in
the trace.  None when the launches and the shapes do not pair up.
"""

KERNEL = "wire_keys_kernel"


def launch_bytes(rows: int, columns: int, k: int) -> int:
    width = (columns - 1) * 16  # the last column holds the row lengths
    return rows * columns * 4 + rows * max(width - k + 1, 0) * (8 + 1)


def read(run):
    kernels = run.trace.kernels(KERNEL)
    shapes = run.batch_shapes()
    if not kernels or len(shapes) != len(kernels):
        return None
    nbytes = sum(launch_bytes(r, c, run.k) for r, c in shapes)
    seconds = sum(d.end - d.ts for d in kernels) * 1e-6
    return 100.0 * nbytes / run.hbm_bytes_per_s / seconds
