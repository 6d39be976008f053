"""Edge cases of the port's kernels, shared by the CPU tests (through the
Pallas kernels and numpy models of the CUDA kernels' indices), the card
tests (``tests/test_torch_gpu.py``) and ``chip_smoke.py`` (which loads
this file by path).  numpy only, no JAX.

* the segment-count kernel: key runs at the edges of its tiles;
* ``segment_copy``: plans whose destinations overlap;
* ``tile_stages``: shift schedules and shapes at every path's edges;
* ``tile_gather``: shapes, step counts and tables at every path's edges;
* ``wire_keys``: row widths and k, and rows at the edges of their length;
* ``codes_keys``: row widths and k, rows at the edges of their length,
  blocks at the edges of their staging (one window a row, one long row),
  views at byte offsets, codes above 3 and the halo'd block;
* ``stream_keys``: streams of reads whose length does and does not divide
  16, at the edges of the kernel's blocks of words.
"""

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


# --- segment_copy and tile_stages ----------------------------------------

N_IN = 5000  # words of the source the overlap plans copy from

# plans whose destinations overlap, so the last writer of a word decides
OVERLAP_PLANS = ["random", "one_offset", "chain", "seg1", "g1"]


def overlap_plan(name: str, seed: int = 0):
    """(in_off, out_off, seg, n_in, n_out) of the named plan: ``random``
    draws 300 destinations of 40 words from [0, n_out - seg] of 2,000;
    ``one_offset`` puts 64 copies at one offset; ``chain`` offsets 200
    copies of 50 words by one word each; ``seg1`` draws 500 one-word
    copies into 50 words; ``g1`` is one copy."""
    rng = np.random.default_rng(seed)
    g, seg, n_out, out_off = {
        "random": (300, 40, 2000, None),
        "one_offset": (64, 33, 100, np.full(64, 17)),
        "chain": (200, 50, 249, np.arange(200)),
        "seg1": (500, 1, 50, None),
        "g1": (1, 77, 100, np.array([5])),
    }[name]
    if out_off is None:
        out_off = rng.integers(0, n_out - seg + 1, g)
    in_off = rng.integers(0, N_IN - seg + 1, g)
    in_off[-1] = N_IN - seg  # a copy that ends at the source's last word
    return in_off, out_off, seg, N_IN, n_out


# tile_stages schedules: empty, zero, negative and |shift| >= len, and
# shifts near +-2^31 whose plain int32 sum overflows
SCHEDULES = {
    "empty": [],
    "zero": [0],
    "zeros": [0, 0, 0],
    "mixed": [-1, 129, 7, -200],
    "near_2_31": [2**31 - 1, 2**31 - 1, -2**31, 5, -2**31 + 3],
}

# (n_rows, lanes, axis, tile_rows): axis 1 at lanes 1 to 4,096, axis 0 at
# tiles of 1 to 4,096 rows (128 lanes: the warp-register path; others
# and tiles above 1,024 rows: the shared-memory paths)
STAGE_SHAPES = [
    (8, 1, 1, None), (8, 31, 1, None), (8, 33, 1, None), (8, 100, 1, None),
    (8, 128, 1, None), (3, 4096, 1, None),
    (4, 128, 0, 1), (6, 33, 0, 3), (16, 128, 0, 8), (1024, 16, 0, 512),
    (1024, 8, 0, 1024), (8192, 3, 0, 4096),
]


def stage_shape_id(shape) -> str:
    n_rows, lanes, axis, tile_rows = shape
    return f"{n_rows}x{lanes}_axis{axis}" + (f"_tile{tile_rows}"
                                               if tile_rows else "")


# tile_gather: (n_rows, lanes, axis, tile_rows), axis 1 at 1 to 4,096
# lanes and axis 0 at tiles of 1 to 4,096 rows; each at every step count
# (1: the direct gather; 3 and 128: composed by squaring, 3 with a product)
GATHER_SHAPES = [
    (8, 1, 1, None), (8, 31, 1, None), (8, 32, 1, None), (8, 33, 1, None),
    (8, 128, 1, None), (3, 4096, 1, None),
    (4, 128, 0, 1), (16, 128, 0, 8), (1024, 8, 0, 512), (8192, 3, 0, 4096),
]
GATHER_STEPS = [1, 3, 128]
GATHER_TABLES = [1, 4096]  # words of a flat table


def gather_case(shape, seed: int = 0):
    """(words [n_rows, lanes] uint32, indices int32) of a gather case."""
    n_rows, lanes, axis, tile_rows = shape
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, (n_rows, lanes), dtype=np.uint64).astype(
        np.uint32)
    bound = lanes if axis == 1 else (tile_rows or n_rows)
    idx = rng.integers(0, bound, (n_rows, lanes)).astype(np.int32)
    return x, idx


# wire_keys: row widths (whole words, and not) and k
WIRE_WIDTHS = [16, 48, 150, 161]
WIRE_KS = [1, 15, 16, 17, 21, 31, 32]


def wire_case(width: int, k: int, rows: int = 12, seed: int = 0):
    """(codes [rows, width] uint8, lengths [rows] uint32): random bases
    with t-leading rows (keys with bit 63 set) and one all-t row (the
    all-ones 32-mer); lengths of 0, k - 1 (below k), width, and random."""
    rng = np.random.default_rng(seed + 1000 * k + width)
    codes = rng.integers(0, 4, (rows, width)).astype(np.uint8)
    codes[::3, 0] = 3
    codes[1, :] = 3
    lengths = rng.integers(0, width + 1, rows).astype(np.uint32)
    lengths[0], lengths[1], lengths[2] = 0, width, max(k - 1, 0)
    lengths[3] = width
    return codes, lengths


# codes_keys: the wire's widths and a 170-base halo'd row, every k the
# kernel treats apart (16 and 17 cross a staged word, 32 takes no shift)
CODES_WIDTHS = [16, 48, 150, 161, 170]
CODES_KS = [1, 2, 15, 16, 17, 21, 31, 32]
# the kernel's output slots a block (kSlotsPerBlock)
CODES_BLOCK = 4096
# (name, rows, width, k): a block spans 4,096 rows of one window each
# (the most staged bytes a block can need) and the next block is partial;
# one row longer than 2^16 bases spans many blocks; rows of 130 windows
# cut by every block edge
CODES_SHAPES = [("one_window_rows", CODES_BLOCK + 5, 32, 32),
                ("one_window_rows_k1", CODES_BLOCK + 5, 1, 1),
                ("long_row", 1, (1 << 16) + 4321, 31),
                ("cut_rows", 70, 150, 21)]


def codes_case(width: int, k: int, rows: int = 12, seed: int = 0):
    """(codes [rows, width] uint8, lengths [rows] int32): ``wire_case``'s
    rows (lengths of 0, k - 1, width and random; t-leading rows and an
    all-t row), lengths as the count paths pass them."""
    codes, lengths = wire_case(width, k, rows, seed)
    return codes, lengths.astype(np.int32)


def codes_shape(name: str, seed: int = 0):
    """(codes, lengths, k) of a ``CODES_SHAPES`` case."""
    _, rows, width, k = next(c for c in CODES_SHAPES if c[0] == name)
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    codes = rng.integers(0, 4, (rows, width)).astype(np.uint8)
    codes[::7, 0] = 3
    lengths = rng.integers(0, width + 1, rows).astype(np.int32)
    lengths[::5] = width
    return codes, lengths, k


def wide_codes(width: int, k: int, rows: int = 12, seed: int = 0):
    """``codes_case`` with a few codes above 3 (up to 255) in one row: the
    plain version ORs their high bits into earlier bases' slots, and the
    kernel's block that holds them takes the plain formula."""
    codes, lengths = codes_case(width, k, rows, seed)
    rng = np.random.default_rng(seed + 7)
    at = rng.integers(0, width, 3)
    codes[rows // 2, at] = rng.integers(4, 256, 3).astype(np.uint8)
    return codes, lengths


# stream_keys: reads back to back, read lengths that divide 16 and not;
# (n_reads, read_len): streams of a few words, of one block of 512 words
# and of a partial second one, and one read of the whole stream (chr)
STREAM_KS = [1, 15, 16, 17, 21, 31, 32]
STREAM_CASES = [(3, 16), (5, 150), (55, 150), (64, 128), (7, 161),
                (1, 16 * 1024 + 16), (2, 33)]
STREAM_BLOCK = 512  # words a kernel block covers (kStreamWords)


def stream_case(n_reads: int, read_len: int, seed: int = 0) -> np.ndarray:
    """Codes [n_reads * read_len] uint8 of reads laid back to back, padded
    with random codes to whole 16-base words, with a t-leading run; pack
    them with ``pack2bit_rows(codes[None])[0]``."""
    rng = np.random.default_rng(seed + 31 * read_len + n_reads)
    n = n_reads * read_len
    codes = rng.integers(0, 4, -(-n // 16) * 16).astype(np.uint8)
    codes[: min(40, n)] = 3
    return codes


# row_sort: int64 keys (signed order) and 32-bit words (unsigned order);
# a kernel block takes a tile of ROW_SORT_TILE[key bytes] keys, one row or
# several whole rows, or, for a small sort of rows that fit it, one warp's
# tile of ROW_SORT_WARP_TILE[key bytes]
ROW_SORT_TILE = {8: 16384, 4: 32768}
ROW_SORT_WARP_TILE = {8: 512, 4: 1024}
ROW_SORT_CASES = ["all_equal", "all_sentinel", "all_flipped_sentinel",
                  "top_heavy", "top_bit_mixed", "descending", "few_values",
                  "width_1", "width_2", "widest", "one_row", "partial_tile",
                  "partial_warp_tile"]


def row_sort_case(name: str, key_bytes: int, seed: int = 0) -> np.ndarray:
    """Rows [n_rows, width] of int64 keys (key_bytes 8) or uint32 words
    (4) for a row_sort edge case.  The sentinel is the count path's
    all-ones key (-1 as int64) and its flipped form (the largest int64);
    ``top_bit_mixed`` sets the top bit of half the keys (signed order puts
    them first for int64 and last for words); ``top_heavy`` makes half
    the keys the dtype's largest value (the engine's pads), which the
    kernel also reads for a run it has used up; ``partial_tile`` leaves
    the last full block 5 of its 16 rows, and ``partial_warp_tile`` the
    last one-warp block 3 rows of 128."""
    rng = np.random.default_rng(seed + sum(map(ord, name)) + key_bytes)
    tile = ROW_SORT_TILE[key_bytes]
    dtype = np.int64 if key_bytes == 8 else np.uint32
    top = np.iinfo(dtype).max

    def rand(shape):
        bits = rng.integers(0, 1 << 63, shape, dtype=np.int64)
        if key_bytes == 4:
            return (bits & 0xFFFFFFFF).astype(np.uint32)
        return bits ^ np.where(rng.random(shape) < 0.5, np.int64(-1 << 63),
                               np.int64(0))

    shape = {"width_1": (300, 1), "width_2": (1000, 2),
             "widest": (3, tile), "one_row": (1, 4096),
             "partial_tile": (21, tile // 16),
             "partial_warp_tile": (ROW_SORT_WARP_TILE[key_bytes] // 128 + 3,
                                   128)}.get(name, (5, 2048))
    if name == "all_equal":
        return np.full(shape, 7, dtype)
    if name == "all_sentinel":
        return np.full(shape, -1 if key_bytes == 8 else top, dtype)
    if name == "all_flipped_sentinel":
        return np.full(shape, top, dtype)
    if name == "few_values":
        return rng.integers(0, 5, shape).astype(dtype)
    x = rand(shape)
    if name == "top_bit_mixed":
        bit = dtype(1 << 31) if key_bytes == 4 else np.int64(-1 << 63)
        x = np.where(rng.random(shape) < 0.5, x | bit, x & ~bit)
    if name == "top_heavy":
        x = np.where(rng.random(shape) < 0.5, top, x)
    if name == "descending":
        x = np.sort(x, axis=1)[:, ::-1]
    return np.ascontiguousarray(x, dtype)
