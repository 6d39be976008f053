"""The probe scripts, ported: what the TPU probes in ``scripts/`` computed
inside ``pl.pallas_call``, run through the port's hand-written probe
kernels (``kernels/tile_gather``, ``tile_stages``, ``row_sort``,
``segment_copy``) and held against their plain PyTorch versions; the
sort-floor probes; and the sample-partition count engine.

    python -m kmer_tpu_torch.probes [--only FAMILY] [--device cuda]
                                    [--small]

* ``capability``: the correctness probes of probe_pallas.py,
  probe_pallas2.py and probe_pallas3.py (gathers, dynamic roll, row sort,
  dynamic-offset copies) against the scripts' numpy oracles;
* ``rates``: the stage-loop and amplified rates of probe_pallas.py (c),
  probe_pallas2.py (c), probe_pallas3.py (0) and (2), probe_r2.py G;
* ``copies``: the copy families of probe_r3a.py F and probe_r3b.py 1a-1e;
* ``sorting``: the sorts, searchsorted, block gathers and per-row counts
  that probe_sort.py, probe_r2.py C-C6, probe_r3a.py A-E, probe_r3b.py
  2-4 and probe_r3c.py timed outside Pallas (``row_sort`` where a row
  fits it, ``segment_copy`` for the block gathers, library calls beside
  them or alone);
* ``partition``: probe_r3c.py's sample-partition count engine, configs A,
  B and C on its uniform and coverage lanes, each equal to
  ``count_windows`` on the same keys.

Not ported: the MXU ``dot_general`` rates of probe_pallas.py (d) and
probe_pallas2.py (h).  They time a one-hot permute on the TPU's matrix
unit, which no sort uses and which the port replaced with index ops
(``ops/dense_count``).  probe_pallas.py (e) and probe_pallas3.py (4) time
the bench's phases and count: ``python -m kmer_tpu_torch bench``.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from . import capability, copies, partition, rates, sorting
from .common import Record

FAMILIES = {"capability": capability, "rates": rates, "copies": copies,
            "sorting": sorting, "partition": partition}


def run_all(device: torch.device | str,
            only: str | tuple[str, ...] | None = None, small: bool = False,
            echo=print) -> list[Record]:
    """Runs the families (or the one named ``only``, or those of a tuple),
    echoing each probe's line as it finishes; returns the records."""
    device = resolve_device(device)
    names = FAMILIES if only is None else (only,) if isinstance(
        only, str) else only
    records = []
    for name, family in FAMILIES.items():
        if name not in names:
            continue
        echo(f"== {name} ==")
        for rec in family.run(device, small=small):
            echo(rec.line())
            records.append(rec)
    return records
