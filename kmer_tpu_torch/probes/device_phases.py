"""Each device phase of a count alone: ``scripts/probe_phases.py`` on the
port.

The workload is the script's: 2^20 simulated reads of 150 bases
(``simulate_reads(seed=0)``), packed to the wire, k = 21 canonical,
136,314,880 windows.  Each phase takes the last one's outputs, resident,
and is timed alone (best of 3 after a warm call, synchronized):

* extract: ``wire_keys`` from the packed wire (keys and valid mask);
* the sort: ``torch.sort(keys ^ SIGN_FLIP)``, values and indices, as
  ``ops/count.count_windows`` sorts.  The script's ``P_sort2``,
  ``P_sort1pay``, ``P_groupsort4`` and ``P_sort1_nopay`` sort the TPU's
  32-bit lanes (two keys, a key and a payload, the group sort, one key);
  here they are this one int64 sort;
* the segment counts: the ``segment_counts`` kernel on the sorted keys.

Then the primitive rates of the script's collision-patch record, each one
torch op: a gather of 136M words from 8.5M, an int32 cumsum of 136M, and
the sized nonzero as ``torch.nonzero`` of the same mask (which reads its
size back to the host: a sync the TPU's ``size=`` form did not pay).

Check: the extract's keys and mask equal ``wire_keys_reference``'s on the
same wire; the segment counts and live total equal
``segment_counts_reference``'s on the same sorted keys, and
``count_windows``' table on the same keys.  Each reference runs beside the
timed calls.  ``small`` takes 2^10 reads.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.segment_counts import segment_counts, segment_counts_reference
from ..kernels.wire_keys import wire_keys, wire_keys_reference
from ..native import pack2bit_rows
from ..ops.count import SENTINEL_KEY, count_windows
from ..ops.extract import simulate_reads
from ..packed import SIGN_FLIP
from ..pipeline import _combine, _upload
from .common import PhaseRecord, best_wall, card_of

READ_LEN, K = 150, 21
SITE = "scripts/probe_phases.py"
LANE_SORTS = ("P_sort2, P_sort1pay, P_groupsort4, P_sort1_nopay (the TPU's "
              "32-bit lane sorts): one int64 sort here")


def run(device: torch.device, small: bool = False, workdir=None):
    """Yields one record a phase and a primitive."""
    n_reads = 1 << (10 if small else 20)
    card = card_of(device)
    reads = simulate_reads(n_reads, READ_LEN, seed=0)
    wire = _upload(_combine(pack2bit_rows(reads),
                            np.full(n_reads, READ_LEN, np.uint16)), device)
    del reads

    def record(name, s, correct=True, **detail):
        return PhaseRecord(name, "device_phases", SITE, str(device), correct,
                           {"best": s}, detail or None, card=card)

    (keys, valid), s = best_wall(
        lambda: wire_keys(wire, READ_LEN, K, True), device)
    n = keys.numel()
    ref_keys, ref_valid = wire_keys_reference(wire, READ_LEN, K, True)
    same = bool(torch.equal(keys, ref_keys) and torch.equal(valid, ref_valid))
    del ref_keys, ref_valid
    yield record("P_extract", s, correct=same, windows=n,
                 G_keys_per_s=round(n / s / 1e9, 3),
                 route="wire_keys (keys and valid mask)")
    flat = keys.view(-1)
    (flipped, _), s = best_wall(lambda: torch.sort(flat ^ SIGN_FLIP), device)
    yield record("P_sort", s, keys=n, G_keys_per_s=round(n / s / 1e9, 3),
                 stands_for=LANE_SORTS)
    sentinel = SENTINEL_KEY ^ SIGN_FLIP
    (counts, n_unique), s = best_wall(
        lambda: segment_counts(flipped, sentinel), device)
    ref_counts, ref_unique = segment_counts_reference(flipped, sentinel)
    same = bool(torch.equal(counts, ref_counts)) and int(n_unique) == int(
        ref_unique)
    del ref_counts
    table = count_windows(keys, valid, K)
    same = same and bool(torch.equal(counts, table.counts)) and int(
        n_unique) == int(table.n_unique)
    yield record("P_segcounts", s, correct=same, keys=n,
                 distinct=int(n_unique))
    del table, counts, flipped, wire

    # the primitive rates, on the extract's keys
    m = n // 16
    g = torch.Generator(device=device).manual_seed(10)
    small_t = torch.randint(0, 1 << 16, (m,), generator=g, device=device,
                            dtype=torch.int32)
    ridx = torch.randint(0, m, (n,), generator=g, device=device)
    _, s = best_wall(lambda: small_t[ridx], device)
    yield record(f"G_gather_{n}_from_{m}", s,
                 G_elems_per_s=round(n / s / 1e9, 3))
    del small_t, ridx
    mask = ((flat >> 16) & 0xFFFF) < 2048  # the script's lo16 < 2048
    _, s = best_wall(lambda: torch.cumsum(mask.to(torch.int32), 0), device)
    yield record(f"G_cumsum_{n}", s, G_elems_per_s=round(n / s / 1e9, 3))
    nz, s = best_wall(lambda: torch.nonzero(mask), device)
    yield record("G_nonzero", s, selected=int(nz.shape[0]),
                 G_elems_per_s=round(n / s / 1e9, 3),
                 note="torch.nonzero reads its size to the host (a sync)")
