"""Key runs at the edges of the segment-count kernel's tiles, shared by
the CPU tests (through the Pallas kernel and a model of the CUDA kernel's
tiling) and the card tests.  Imports no JAX."""

import numpy as np

# the CUDA kernel's tile in keys, for the CPU tests; the card tests take
# the built kernel's, segment_counts_tile()
TILE = 4096
# cases small enough for the Pallas kernel in interpret mode
EDGES = ["tail_at_tile_end", "head_at_tile_start",
         "three_tiles_ending_mid_tile", "halo_edge_31", "halo_edge_32",
         "halo_edge_33", "sentinel_run_spanning_tiles", "n_T_minus_1", "n_T",
         "n_T_plus_1"]
# larger ones: runs past the staged halo (galloping searches), one run
# over every tile, an odd n
LARGE = ["long_runs", "one_run_over_every_tile", "odd_n"]


def edge_runs(name: str, t: int) -> tuple[np.ndarray, int]:
    """(run lengths, sentinel-run length) for tiles of ``t`` keys: run i
    holds key i, and the sentinel run comes last."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "tail_at_tile_end":
        return np.array([t - 10, 10, 50]), 0
    if name == "head_at_tile_start":
        return np.array([t, 20, 30]), 0
    if name == "three_tiles_ending_mid_tile":
        return np.array([t // 2, 2 * t + 7, 100]), 0
    if name.startswith("halo_edge_"):  # a run from t - d across the edge
        return np.array([t - int(name.rsplit("_", 1)[1]), 40, 5]), 0
    if name == "sentinel_run_spanning_tiles":
        return rng.integers(1, 9, 700), 2 * t + 100
    if name == "long_runs":  # 1 to 30,000 keys, some runs long, most short
        return np.where(rng.random(300) < 0.3, rng.integers(1, 30_000, 300),
                        rng.integers(1, 40, 300)), 3 * t + 11
    if name == "one_run_over_every_tile":
        return np.array([20 * t + 3, 2]), 0
    n = {"n_T_minus_1": t - 1, "n_T": t, "n_T_plus_1": t + 1,
         "odd_n": 12345}[name]  # n keys drawn from 900 values
    return np.bincount(rng.integers(0, 900, n), minlength=900), 0
