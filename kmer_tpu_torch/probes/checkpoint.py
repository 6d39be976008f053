"""One checkpoint write split up: ``scripts/probe_r4b.py`` on the port.

The workload is the script's: an accumulator of 4,194,304 slots with
999,980 live rows from ``default_rng(0)`` (sorted random ``hi`` words,
random ``lo`` words, k = 21, counts 1 to 99,999), built in the port's
lanes (one int64 key, an int32 length, an int64 count) on the device.
Each part is timed twice:

* the live count on the device;
* each lane's copy of the first live-count slots to the host;
* the host compaction: the live rows, split into ``kmer_tpu``'s five
  lanes (``parallel.streaming._lanes``);
* the write of the v2 layout through ``atomic_savez``, compressed and
  plain (``parallel.streaming._write_v2``);
* ``save_wide`` whole, compressed (its default) and plain (as the
  stream's checkpoints write it).

The files' sizes are printed.  Check: every file loads through
``load_wide`` to the accumulator's live rows.  ``small``: 2^14 slots and
3,000 live rows.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.count import SENTINEL, SENTINEL_LEN
from ..ops.wide import WideCounts
from ..parallel.streaming import _lanes, _write_v2, load_wide, save_wide
from .common import PhaseRecord, card_of, table_digest, twice, workspace

CAP, LIVE, K = 4 * 1024 * 1024, 999_980, 21
SMALL = (1 << 14, 3_000)
META = {"mesh_shape": [1, 1]}
FILES = {"atomic_savez compressed": "r4b_c.npz",
         "atomic_savez plain": "r4b_p.npz",
         "save_wide compressed": "r4b_s.npz",
         "save_wide plain": "r4b_sp.npz"}
SITE = "scripts/probe_r4b.py"


def accumulator(cap: int, live: int, device: torch.device) -> WideCounts:
    """The script's accumulator, in the port's lanes on ``device``."""
    rng = np.random.default_rng(0)
    hi = np.full(cap, SENTINEL, np.uint32)
    lo = np.full(cap, SENTINEL, np.uint32)
    ln = np.full(cap, SENTINEL_LEN, np.int32)
    cl = np.zeros(cap, np.uint32)
    hi[:live] = np.sort(rng.integers(0, 1 << 32, live).astype(np.uint32))
    lo[:live] = rng.integers(0, 1 << 32, live).astype(np.uint32)
    ln[:live] = K
    cl[:live] = rng.integers(1, 100_000, live).astype(np.uint32)
    return WideCounts.from_numpy(hi, lo, ln, np.zeros(cap, np.int32), cl,
                                 device=device)


def run(device: torch.device, small: bool = False, workdir=None):
    """Yields one record a part of the write, then the files' check."""
    card = card_of(device)
    cap, live = SMALL if small else (CAP, LIVE)
    acc = accumulator(cap, live, device)
    want = table_digest(acc)

    def record(name, seconds, correct=True, **detail):
        return PhaseRecord(name, "checkpoint", SITE, str(device), correct,
                           {name: seconds}, detail or None, card=card)

    n, times = twice(lambda: int((acc.counts > 0).sum()), device)
    yield record("live count", times, n == live, live=n)
    slabs, per_lane = {}, {}
    for lane in ("keys", "length", "counts"):
        slabs[lane], per_lane[lane] = twice(
            lambda: getattr(acc, lane)[:n].cpu(), device)
    copied = all(t.shape[0] == n for t in slabs.values()) and int(
        slabs["counts"].sum()) == int(acc.counts.sum())
    yield PhaseRecord(
        "lane copies to the host", "checkpoint", SITE, str(device), copied,
        per_lane, {"bytes": sum(t.nbytes for t in slabs.values())},
        card=card)

    def compact():
        keep = slabs["counts"] > 0
        return _lanes(*(slabs[lane][keep] for lane in ("keys", "length",
                                                        "counts")))

    lanes, times = twice(compact, device)
    yield record("host compaction", times, lanes.shape[1] == live)
    with workspace(workdir) as d:
        paths = {name: os.path.join(d, f) for name, f in FILES.items()}
        writes = {
            "atomic_savez compressed": lambda p: _write_v2(
                p, lanes, [live], cap, live, META, compress=True),
            "atomic_savez plain": lambda p: _write_v2(
                p, lanes, [live], cap, live, META, compress=False),
            "save_wide compressed": lambda p: save_wide(acc, p, META),
            "save_wide plain": lambda p: save_wide(acc, p, META,
                                                   compress=False)}
        for name, write in writes.items():
            _, times = twice(lambda: write(paths[name]), device)
            loaded = table_digest(load_wide(paths[name])[0])
            yield record(name, times, loaded == want,
                         bytes=os.path.getsize(paths[name]),
                         reloads=loaded == want)
