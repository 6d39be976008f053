"""The sustained step split up, and the merge-cadence lever:
``scripts/probe_step.py`` and ``scripts/probe_r5d.py`` on the port.

The workload is the sustained one: batches of 524,288 x 150 bp reads of
one 1 Mbp genome (``default_rng(0)``), source i drawn from
``default_rng(100 + i)`` with half its reads reverse-complemented, as
``runs.sustained.sources`` (and r5d) draw them; k = 21 canonical, 4M
slots.  The batches stay on the card as codes and as the packed wire.

probe_step (source 0), each best of 3 after a warm call:

* extract: ``wire_keys`` from the wire, ``codes_keys`` on the same
  batch's codes through ``parallel.dist._extract_with_halo`` (what a
  stream step fed codes runs), and beside them the plain composition of
  that halo'd extraction (the halo and ``codes_keys_reference``);
* ``fold_windows_into_wide`` onto an empty accumulator, and onto the warm
  one it made;
* ``count_windows`` and ``merge_into_wide`` apart;
* the whole ``make_sharded_stream_step`` on a (1,1) mesh, fed codes and
  fed the wire (``packed_width=160``), three steps each after a warm one.

r5d, 12 steps over sources 0-3, R = 4:

* per batch: ``fold_windows_into_wide`` (the shipped fold);
* the cadence: each batch counted (``count_windows``) and compacted
  (``table_groups``), and every R batches one general
  ``count_packed_wide`` over the accumulator and the R tables.  That
  weighted GROUP BY takes the place of r5d's ``_narrow_to_cap``, a TPU
  compaction with no counterpart.

Both read the wire through ``wire_keys``.  The verdict is r5d's rule: the
cadence would ship at 1.15x or more.  It is a finding; the engine does not
change.

Check: the fold equals the count + merge, both steps give one table with
no overflow, and the two compositions of r5d are equal row for row.
``small`` takes batches of 256 reads of a 10,000-base genome into 2^16
slots.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.codes_keys import codes_keys_reference
from ..kernels.wire_keys import wire_keys
from ..native import pack2bit_rows
from ..ops.count import count_windows
from ..ops.wide import (
    WideCounts, count_packed_wide, fold_windows_into_wide, merge_into_wide,
    table_groups)
from ..parallel.dist import _extract_with_halo
from ..parallel.mesh import make_mesh
from ..parallel.streaming import empty_sharded_acc, make_sharded_stream_step
from ..pipeline import _combine, _upload
from .common import PhaseRecord, best_wall, card_of, table_digest, wall

K, READ_LEN = 21, 150
BATCH, GENOME, CAP = 512 * 1024, 1_000_000, 4 * 1024 * 1024
SMALL = (256, 10_000, 1 << 16)  # batch, genome, slots
R, STEPS = 4, 12
WIDTH = 160  # the wire's bases a row: 10 words
SITES = {"step": "scripts/probe_step.py", "r5d": "scripts/probe_r5d.py"}


def sources(batch: int, n: int, genome_bases: int) -> list[np.ndarray]:
    """The first ``n`` sources of ``runs.sustained.sources``: reads [batch,
    150] uint8 codes of one genome, source i from ``default_rng(100 + i)``,
    half of them reverse-complemented."""
    genome = np.random.default_rng(0).integers(0, 4, genome_bases,
                                               dtype=np.uint8)
    windows = np.lib.stride_tricks.sliding_window_view(genome, READ_LEN)
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        reads = windows[rng.integers(0, genome_bases - READ_LEN + 1,
                                     size=batch)]
        flip = rng.random(batch) < 0.5
        reads[flip] = 3 - reads[flip, ::-1]
        out.append(reads)
    return out


def resident(reads: np.ndarray, device: torch.device
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(codes [B, 150] uint8, lengths [B] int32, wire [B, 11] int32) of a
    batch, on ``device``."""
    n = reads.shape[0]
    lengths = np.full(n, READ_LEN, np.int32)
    wire = _combine(pack2bit_rows(reads), lengths)
    return (torch.from_numpy(reads).to(device),
            torch.from_numpy(lengths).to(device), _upload(wire, device))


def _keys(wire: torch.Tensor):
    return wire_keys(wire, WIDTH, K, True)


def _plain_halo(codes, lengths):
    """``_extract_with_halo`` on a (1,1) mesh with the plain version: the
    zero halo, then ``codes_keys_reference``."""
    ext = torch.cat([codes, codes.new_zeros((codes.shape[0], K - 1))], 1)
    return codes_keys_reference(ext, lengths, K, True)


def step_parts(device, codes, lengths, wire, cap, card):
    """probe_step's records."""
    site = SITES["step"]
    mesh = make_mesh((1, 1), device=device)

    def record(name, seconds, correct=True, tables=None, **detail):
        return PhaseRecord(name, "fold_step", site, str(device), correct,
                           seconds, detail or None, tables, card=card)

    (keys, valid), s = best_wall(lambda: _keys(wire), device)
    got, s_codes = best_wall(lambda: _extract_with_halo(
        codes, lengths, K, mesh, True), device)
    want, s_plain = best_wall(lambda: _plain_halo(codes, lengths), device)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    yield record("extract", {"wire_keys": s, "codes_keys": s_codes,
                             "plain": s_plain}, same,
                 windows=int(valid.sum()))
    del got, want
    empty = WideCounts.empty(cap, device)
    acc1, s1 = best_wall(lambda: fold_windows_into_wide(empty, keys, valid,
                                                        K), device)
    acc2, s2 = best_wall(lambda: fold_windows_into_wide(acc1, keys, valid,
                                                        K), device)
    table, sc = best_wall(lambda: count_windows(keys, valid, K), device)
    merged, sm = best_wall(lambda: merge_into_wide(acc1, table), device)
    folds = {"fold empty": table_digest(acc1),
             "fold warm": table_digest(acc2)}
    same = table_digest(merged) == folds["fold warm"]
    yield record("fold_windows_into_wide", {"empty acc": s1, "warm acc": s2},
                 same and acc2.n_unique <= cap, folds,
                 n_unique=acc1.n_unique)
    yield record("count_windows + merge_into_wide",
                 {"count_windows": sc, "merge_into_wide": sm}, same)
    del table, merged, acc2, keys, valid

    results = {}
    for name, packed, batch in (("codes", None, (codes, lengths)),
                                ("wire", WIDTH, (wire[:, :-1], lengths))):
        step = make_sharded_stream_step(mesh, K, True, cap,
                                        packed_width=packed)
        zero = torch.zeros((), dtype=torch.int64, device=device)
        acc, ovf = step(empty_sharded_acc(mesh, cap), zero, *batch)
        times = []
        for _ in range(3):
            (acc, ovf), s = wall(lambda: step(acc, ovf, *batch), device)
            times.append(s)
        results[name] = table_digest(acc)
        yield record(f"stream step fed {name}", {"step": times},
                     int(ovf) == 0, {f"{name}, 4 steps": results[name]},
                     overflow=int(ovf), n_unique=acc.n_unique)
    same = results["codes"] == results["wire"]
    yield record("stream step: codes == wire", {}, same)


def cadence(device, wires, cap, steps, r, card):
    """r5d's two compositions, timed and compared."""
    def shipped():
        acc = WideCounts.empty(cap, device)
        for i in range(steps):
            acc = fold_windows_into_wide(acc, *_keys(wires[i % len(wires)]),
                                         K)
        return acc

    def flush(acc, segs):
        keys = torch.cat([acc.keys] + [k for k, _ in segs])
        counts = torch.cat([acc.counts] + [c for _, c in segs])
        length = torch.full_like(keys, K, dtype=torch.int32)
        return count_packed_wide(keys, length, counts, cap)

    def cadenced():
        acc, segs = WideCounts.empty(cap, device), []
        for i in range(steps):
            segs.append(table_groups(count_windows(
                *_keys(wires[i % len(wires)]), K)))
            if len(segs) == r:
                acc, segs = flush(acc, segs), []
        return flush(acc, segs) if segs else acc

    a, b = shipped(), cadenced()  # warm both
    tables = {"shipped": table_digest(a), "cadence": table_digest(b)}
    exact = tables["shipped"] == tables["cadence"]
    fits = max(a.n_unique, b.n_unique) <= cap
    del a, b
    _, t_ship = wall(shipped, device)
    _, t_cad = wall(cadenced, device)
    speedup = t_ship / t_cad
    return PhaseRecord(
        f"merge cadence R={r}", "fold_step", SITES["r5d"], str(device),
        exact and fits, {"shipped": t_ship, "cadence": t_cad},
        {"steps": steps, "shipped_ms_step": round(1e3 * t_ship / steps, 3),
         "cadence_ms_step": round(1e3 * t_cad / steps, 3),
         "speedup": round(speedup, 3), "exact": exact,
         "verdict": ("ACCEPT (ship)" if speedup >= 1.15
                     else "REJECT (measured-shut)")}, tables, card=card)


def run(device: torch.device, small: bool = False, workdir=None):
    """Yields probe_step's records, then r5d's."""
    card = card_of(device)
    batch, genome, cap = SMALL if small else (BATCH, GENOME, CAP)
    batches = [resident(reads, device)
               for reads in sources(batch, R, genome)]
    yield from step_parts(device, *batches[0], cap, card)
    wires = [w for _, _, w in batches]
    del batches
    yield cadence(device, wires, cap, STEPS, R, card)
