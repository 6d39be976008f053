"""codes -> keys kernel (``kernels.codes_keys``, ``csrc/codes_keys.cu``,
launched by ``parallel.dist._extract_with_halo`` in the sharded stream's
step): its share of the least time its bytes take at the card's HBM peak.

Bytes of one launch, as the port's kernel table counts them (its row
22): the halo'd codes read once (a row's bases and the k - 1 bases of
the halo, which a (1, 1) mesh fills with zeros), a 4-byte length a row,
and for every slot (``bases`` windows a row) an 8-byte key and a 1-byte
valid flag written once.  The shapes are those the job fed
(``codes_shape``, one a batch).  Divided by the kernel's summed time in
the trace.  None when the launches and the batches do not pair up.
"""

KERNEL = "codes_keys_kernel"


def launch_bytes(rows: int, bases: int, k: int) -> int:
    return rows * (bases + k - 1) + 4 * rows + rows * bases * (8 + 1)


def read(run):
    kernels = run.trace.kernels(KERNEL)
    shapes = [tuple(j["codes_shape"]) for j in run.jobs
              if "codes_shape" in j for _ in range(j["batches"])]
    if not kernels or len(shapes) != len(kernels):
        return None
    nbytes = sum(launch_bytes(r, b, run.k) for r, b in shapes)
    seconds = sum(d.end - d.ts for d in kernels) * 1e-6
    return 100.0 * nbytes / run.hbm_bytes_per_s / seconds
