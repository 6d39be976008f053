"""Stage-loop and amplified rates of the Pallas probes, on the card.

``scripts/probe_pallas.py`` (c), ``probe_pallas2.py`` (c),
``probe_pallas3.py`` (0) and (2), and ``probe_r2.py`` G, at the scripts'
shapes and stage schedules.  Each prints the kernel's and the plain
version's ms and G ops/s with the script's op count (words times stages
times chained launches); the dispatch probes print ms only.  Where the
kernel composes the stages (``add1`` into one pass, the gathers by
repeated squaring), that count is the script's stage count, not the
operations issued, and the line says so.
The kernel's result must equal the plain version's.

``jax.random`` inputs become seeded numpy draws.  ``jnp.roll`` and
``pltpu.roll`` agree (np.roll's direction), so the two lane-roll probes
of probe_pallas2 run the same kernel; ``concat([h[d:], h[:d]])`` is a
shift of -d.  ``small`` cuts the number of tiles and chained launches
(never a tile's shape or the stage schedule) for a quick run on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.tile_gather import tile_gather, tile_gather_reference
from ..kernels.tile_stages import tile_stages, tile_stages_reference
from .common import Record, max_abs_err, time_ms, words

L = 128
# int32 operations a dependent stage costs a word: take2 compares (hi, lo)
# with its partner's (two compares, an and, an or) and selects both lanes
# by one predicate; a roll is addressing, not arithmetic
STAGE_COST = {"take2": 4, "min": 1, "min_add1": 2}
LOOP = "none: a loop of dependent stages is no one call"
STAGE_OPS = "stage-ops (the script's count, not issued operations)"


def issued_ops(op: str, words: int, stages: int) -> int:
    """int32 operations the kernel must issue for ``stages`` stages of
    ``op`` over ``words`` words: add1's stages compose into one add a word
    and copy's into one roll, so bytes bound those two; ``gather`` steps
    compose into bit_length - 1 squarings and popcount products of the
    index map (the last one gathers the words), one operation a word
    each."""
    if op == "add1":
        return words
    if op == "copy":
        return 0
    if op == "gather":
        return words * (stages.bit_length() - 1 + bin(stages).count("1"))
    return words * stages * STAGE_COST[op]


def _random_words(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _stages(name, site, device, rows, op, axis, shifts, reps=1,
            tile_rows=None, count_ops=True, seed=0):
    rng = np.random.default_rng(seed)
    h = words(_random_words(rng, (rows, L)), device)
    lo = words(_random_words(rng, (rows, L)), device) if op == "take2" else None
    sched = torch.tensor(shifts, dtype=torch.int32, device=device)

    def chain(fn):
        def go():
            x, y = h, lo
            for _ in range(reps):
                out = fn(x, sched, op, axis, lo=y, tile_rows=tile_rows)
                x, y = out if y is not None else (out, None)
            return x if y is None else (x, y)
        return go

    run, plain = chain(tile_stages), chain(tile_stages_reference)
    err = max_abs_err(run(), plain())
    iters = 20 if rows * len(shifts) * reps <= 1 << 16 else 3
    stages = len(shifts) * reps
    lanes = 2 if op == "take2" else 1
    library = LOOP, None
    if op == "add1":  # the stages add up to one add, mod 2^32
        library = f"x + {stages}", lambda: h + stages
    return Record(name, "rates", "tile_stages", site, str(device),
                  correct=err == 0,
                  max_abs_err=err, ms=time_ms(run, device, iters),
                  plain_ms=time_ms(plain, device, 1),
                  ops=rows * L * stages if count_ops else None,
                  ops_label=STAGE_OPS if op == "add1" else "ops").own_times(
        run, device, 2 * lanes * rows * L * 4 + 4 * len(shifts),
        issued_ops(op, rows * L, stages), *library)


def _gather(name, site, device, tiles, rows, axis, steps, seed=1):
    rng = np.random.default_rng(seed)
    big = words(_random_words(rng, (tiles * rows, L)), device)
    idx = rng.integers(0, rows, (tiles * rows, L)).astype(np.int32)
    if axis == 1:
        idx %= L
    it = words(idx, device)
    err = max_abs_err(
        tile_gather(big, it, axis, tile_rows=rows, steps=steps, add=1),
        tile_gather_reference(big, it, axis, tile_rows=rows, steps=steps,
                              add=1))

    def run():
        return tile_gather(big, it, axis, tile_rows=rows, steps=steps, add=1)

    # words and indices read, words written; the rate counts the script's
    # gather steps, the bound the composed gathers the kernel issues
    n = tiles * rows * L
    return Record(
        name, "rates", "tile_gather", site, str(device), correct=err == 0,
        max_abs_err=err, ms=time_ms(run, device, 3),
        plain_ms=time_ms(lambda: tile_gather_reference(
            big, it, axis, tile_rows=rows, steps=steps, add=1), device, 1),
        ops=n * steps, ops_label=STAGE_OPS).own_times(
        run, device, 3 * n * 4, issued_ops("gather", n, steps),
        "none: a loop of dependent gathers is no one call")


def _doubling(n, mod=7, base=1, sign=1):
    return [sign * (base << (s % mod)) for s in range(n)]


def run(device: torch.device, small: bool = False, workdir=None):
    """Yields the Record of every rate probe."""
    cut = 64 if small else 1
    p1 = "scripts/probe_pallas.py:113"
    p2 = "scripts/probe_pallas2.py:89"
    yield _stages("vpu_cmpex", p1, device, 1024, "take2", 1, _doubling(64),
                  reps=64 // cut)
    yield _stages("cmpex_jnp_roll_lanes", p2, device, 1024, "take2", 1,
                  _doubling(256))
    yield _stages("cmpex_pltpu_roll_lanes", p2, device, 1024, "take2", 1,
                  _doubling(256))
    yield _stages("cmpex_jnp_roll_rows", p2, device, 1024, "take2", 0,
                  _doubling(256))
    yield _stages("cmpex_concat_rows", p2, device, 1024, "take2", 0,
                  _doubling(256, sign=-1))
    yield _stages("minex_roll_rows_1lane", "scripts/probe_pallas2.py:143",
                  device, 1024, "min", 0, _doubling(256))
    for rows in (8, 1024):
        yield _stages(f"dispatch_overhead ({rows}, 128)",
                      "scripts/probe_pallas3.py:32", device, rows, "add1",
                      1, [0], count_ops=False)

    # probe_pallas3 (2): a grid of 128 tiles [512, 128], 128 steps each
    p3 = "scripts/probe_pallas3.py:86"
    tiles, br, steps = 128 // cut, 512, 128
    yield _stages("cmpex1_roll_lanes(amplified)", p3, device, tiles * br,
                  "min_add1", 1, _doubling(steps), tile_rows=br)
    yield _stages("cmpex1_roll_rows(amplified)", p3, device, tiles * br,
                  "min_add1", 0, _doubling(steps), tile_rows=br)
    yield _gather("gather_lanes(amplified)", p3, device, tiles, br, 1, steps)
    yield _gather("gather_rows(amplified)", p3, device, tiles, br, 0, steps)
    yield _stages("plain_add(amplified)", p3, device, tiles * br, "add1", 1,
                  [0] * steps, tile_rows=br)

    # probe_r2 G: 64 tiles [512, 128], 128 steps, static concat shifts
    tiles = 64 // cut
    yield _stages("G_cmpex_static_concat", "scripts/probe_r2.py:150", device,
                  tiles * br, "min_add1", 1, _doubling(steps, sign=-1),
                  tile_rows=br)
    yield _stages("G2_cmpex_static_axis0", "scripts/probe_r2.py:164", device,
                  tiles * br, "min_add1", 0,
                  _doubling(steps, mod=4, base=8, sign=-1), tile_rows=br)
