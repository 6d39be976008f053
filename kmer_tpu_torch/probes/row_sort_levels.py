"""Where ``row_sort``'s time goes, on the card: the kernel of
``csrc/row_sort.cu`` built three times, with its merge levels stopped
before the first (the load, the register sort and the store alone), after
the in-warp levels (runs up to 32 threads' keys), and not at all (the
shipped kernel), each timed on the same int64 rows in a CUDA graph with
its inputs out of the L2, beside ``torch.sort(dim=1)`` and the byte
bound.  Only the whole build sorts; the others are timings.

    python -m kmer_tpu_torch.probes.row_sort_levels [--rows 8320]
                                                    [--width 16384]

Prints one line a build and a JSON record last.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from concurrent.futures import ThreadPoolExecutor

import torch

from ..device import resolve_device
from ..kernels.build import CSRC_DIR, NVCC_FLAGS, _nvcc, build_library
from ..kernels.row_sort import row_sort_reference
from ..kernels.words import stream_of
from .common import bound_ms, graph_ms

PER_THREAD = 16  # int64 keys a thread (Keys<int64_t>::kPerThread)


def _build(option: tuple[str, int] | None):
    """The kernel built with one ``-D`` option (``(name, value)``) or as
    shipped, loaded; returns its launch function."""
    name, flags = "librow_sort.so", []
    if option is not None:
        name = f"librow_sort_{option[0].lower()}{option[1]}.so"
        flags = [f"-D{option[0]}={option[1]}"]
    lib = ctypes.CDLL(build_library(f"{CSRC_DIR}/row_sort.cu", name,
                                    [_nvcc(), *NVCC_FLAGS, *flags]))
    fn = lib.row_sort_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="kmer_tpu_torch.probes.row_sort_levels",
                                description=__doc__)
    p.add_argument("--rows", type=int, default=8320)
    p.add_argument("--width", type=int, default=16384)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    builds = {
        "load, register sort, store": ("ROW_SORT_MERGE_UNTIL", PER_THREAD),
        "and the in-warp levels": ("ROW_SORT_MERGE_UNTIL", 32 * PER_THREAD),
        "whole": None}
    with ThreadPoolExecutor(len(builds)) as pool:
        fns = dict(zip(builds, pool.map(_build, builds.values())))
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(-(1 << 62), 1 << 62, (args.rows, args.width),
                      dtype=torch.int64, device=dev, generator=gen)
    out = torch.empty_like(x)

    def launch(fn):
        err = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], 8,
                 stream_of(x))
        if err:
            raise RuntimeError(f"row_sort launch failed ({err})")
        return out

    bound, by = bound_ms(2 * x.nbytes, 0, dev)
    record = {"card": torch.cuda.get_device_name(dev),
              "shape": [args.rows, args.width], "bound_ms": bound,
              "bound_by": by, "ms": {}}
    for what, option in builds.items():
        fn = fns[what]
        launch(fn)
        if option is None and not torch.equal(out, row_sort_reference(x)):
            raise RuntimeError("the shipped build does not sort")
        record["ms"][what] = ms = graph_ms(lambda: launch(fn), dev, cold=True)
        print(f"row_sort {what}: {ms:.4f} ms ({100 * bound / ms:.1f}% of "
              f"the {bound:.4f} ms bound)", flush=True)
    record["ms"]["torch.sort(dim=1)"] = ms = graph_ms(
        lambda: torch.sort(x, dim=1), dev, cold=True)
    print(f"torch.sort(dim=1): {ms:.4f} ms", flush=True)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
