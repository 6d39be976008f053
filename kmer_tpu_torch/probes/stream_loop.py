"""The stream loop, free-running and with checkpoint writes:
``scripts/probe_r4c.py`` and ``scripts/probe_r4d.py`` on the port.

The workload is ``fold_step``'s: batches of 150 bp reads of one 1 Mbp
genome, the sustained stream's sources (r4c and r4d drew theirs from the
genome's own generator: the same shapes and coverage), k = 21 canonical,
4M slots, raw codes on the card, one ``make_sharded_stream_step`` on a
(1,1) mesh (each step makes its windows' keys in one ``codes_keys``
launch and folds them through the segment-count kernel, as
``runs.sustained`` does).

r4c: 8 batches of 524,288 reads, 151 steps, batch i being source i mod 8,
after one warm step:

* A: free-running;
* D: with checkpoint writes: ``save_wide`` (uncompressed, as the stream's
  checkpoints are) on an ``AsyncCheckpointer`` thread, at the cadence of
  ``stream_sharded_count``: an opportunity every 16 steps, taken when the
  time since the last write is at least 9 times the last write's (a 10%
  target overhead; the first is always taken);
* B and C pace JAX's asynchronous dispatch (``is_ready`` polls, a block
  every 8 steps).  Torch's eager step waits where it reads a size, so they
  have no counterpart.

Each prints ms a step, k-mers/s, the writes and the loop's stall on them
(``wait_s``).  r4d: batches of 512k, 1M and 2M reads (4 sources each), 24,
16 and 10 steps, with writes as in D.

Check: no overflow; D's table equals A's; each loop ends with the groups
it had after one pass over its sources (the later batches repeat them),
and at full size with every window of the genome, 999,980.  ``small``:
batches of 256, 512 and 1,024 reads of a 10,000-base genome into 2^16
slots, 12 steps for A and D, 5, 4 and 3 for r4d, an opportunity every 4.
"""

from __future__ import annotations

import os
import time

import torch

from ..parallel.mesh import make_mesh
from ..parallel.streaming import (
    AsyncCheckpointer, empty_sharded_acc, make_sharded_stream_step, save_wide)
from ..runs.sustained import FULL_DISTINCT
from ..utils.profiling import synchronize
from .common import PhaseRecord, card_of, table_digest, workspace
from .fold_step import BATCH, CAP, GENOME, K, READ_LEN, SMALL, sources

R4C_STEPS = 151
R4D = ((512 * 1024, 24), (1024 * 1024, 16), (2 * 1024 * 1024, 10))
SMALL_R4C_STEPS = 12
SMALL_R4D = ((256, 5), (512, 4), (1024, 3))
CKPT_EVERY, SMALL_CKPT_EVERY = 16, 4
OVERHEAD = 0.1  # stream_sharded_count's target checkpoint overhead
SITES = {"r4c": "scripts/probe_r4c.py", "r4d": "scripts/probe_r4d.py"}


def stream_loop(step, mesh, codes, lengths, steps, cap, ckpt=None,
                every=CKPT_EVERY) -> dict:
    """``steps`` stream steps over the resident batches ``codes`` (batch i
    is ``codes[i % len(codes)]``), with checkpoint writes to ``ckpt`` at
    ``stream_sharded_count``'s cadence; the loop's wall and what it
    wrote."""
    device = mesh.device
    acc = empty_sharded_acc(mesh, cap)
    ovf = torch.zeros((), dtype=torch.int64, device=device)
    writer = None if ckpt is None else AsyncCheckpointer(
        lambda a: save_wide(a, ckpt, {"mesh_shape": [1, 1]}, compress=False))
    uniques, writes, last = [], 0, float("-inf")
    synchronize(device)
    t0 = time.perf_counter()
    for i in range(steps):
        acc, ovf = step(acc, ovf, codes[i % len(codes)], lengths)
        uniques.append(acc.n_unique)
        if writer is None or (i + 1) % every:
            continue
        if time.perf_counter() - last >= writer.last_write_s * (
                1 / OVERHEAD - 1):
            last = time.perf_counter()
            synchronize(device)  # the snapshot's work is done
            writer.submit(acc)
            writes += 1
    if writer is not None:
        writer.close()
    synchronize(device)
    dt = time.perf_counter() - t0
    return {"s": dt, "table": table_digest(acc), "n_unique": acc.n_unique,
            "overflow": int(ovf), "writes": writes,
            "wait_s": 0.0 if writer is None else writer.wait_s,
            "first_pass": uniques[min(len(codes), steps) - 1]}


def _record(name, site, device, out, steps, batch, card, correct,
            **detail):
    kmers = steps * batch * (READ_LEN - K + 1)
    return PhaseRecord(
        name, "stream_loop", site, str(device), correct,
        {"loop": out["s"]},
        {"steps": steps, "batch": batch,
         "ms_step": round(1e3 * out["s"] / steps, 3),
         "Mkmers/s": round(kmers / out["s"] / 1e6, 1),
         "writes": out["writes"], "wait_s": round(out["wait_s"], 4),
         "n_unique": out["n_unique"], **detail}, {"table": out["table"]},
        card=card)


def run(device: torch.device, small: bool = False, workdir=None):
    """Yields r4c's A and D, then one record a batch size of r4d."""
    card = card_of(device)
    batch, genome, cap = SMALL if small else (BATCH, GENOME, CAP)
    every = SMALL_CKPT_EVERY if small else CKPT_EVERY
    r4c_steps = SMALL_R4C_STEPS if small else R4C_STEPS
    r4d = SMALL_R4D if small else R4D
    mesh = make_mesh((1, 1), device=device)

    def ok(out, want_table=None):
        good = out["overflow"] == 0 and out["n_unique"] == out["first_pass"]
        if not small:
            good = good and out["n_unique"] == FULL_DISTINCT
        return good and want_table in (None, out["table"])

    def resident(b, n):
        return ([torch.from_numpy(r).to(device)
                 for r in sources(b, n, genome)],
                torch.full((b,), READ_LEN, dtype=torch.int32, device=device))

    with workspace(workdir) as d:
        ckpt = os.path.join(d, "stream_loop.npz")
        step = make_sharded_stream_step(mesh, K, True, cap)
        codes, lengths = resident(batch, 8)
        step(empty_sharded_acc(mesh, cap),
             torch.zeros((), dtype=torch.int64, device=device), codes[0],
             lengths)  # warm
        a = stream_loop(step, mesh, codes, lengths, r4c_steps, cap)
        yield _record("r4c A free-run", SITES["r4c"], device, a, r4c_steps,
                      batch, card, ok(a),
                      B_C="no counterpart: JAX dispatch pacing")
        dd = stream_loop(step, mesh, codes, lengths, r4c_steps, cap, ckpt,
                         every)
        yield _record("r4c D with checkpoint writes", SITES["r4c"], device,
                      dd, r4c_steps, batch, card, ok(dd, a["table"]))
        del codes
        for b, steps in r4d:
            codes, lengths = resident(b, 4)
            out = stream_loop(step, mesh, codes, lengths, steps, cap, ckpt,
                              every)
            del codes
            yield _record(f"r4d B={b} with checkpoint writes", SITES["r4d"],
                          device, out, steps, b, card, ok(out))
