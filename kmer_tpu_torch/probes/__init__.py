"""The Pallas probe scripts, ported: what the TPU probes in ``scripts/``
computed inside ``pl.pallas_call``, run through the port's hand-written
probe kernels (``kernels/tile_gather``, ``tile_stages``, ``row_sort``,
``segment_copy``) and held against their plain PyTorch versions.

    python -m kmer_tpu_torch.probes [--only capability|rates|copies]
                                    [--device cuda] [--small]

* ``capability``: the correctness probes of probe_pallas.py,
  probe_pallas2.py and probe_pallas3.py (gathers, dynamic roll, row sort,
  dynamic-offset copies) against the scripts' numpy oracles;
* ``rates``: the stage-loop and amplified rates of probe_pallas.py (c),
  probe_pallas2.py (c), probe_pallas3.py (0) and (2), probe_r2.py G;
* ``copies``: the copy families of probe_r3a.py F and probe_r3b.py 1a-1e.

The scripts' non-Pallas parts (``lax.sort`` row sorts, the MXU
``dot_general`` rates, searchsorted, the vmap block gather) are not
ported here.  probe_pallas.py (e) and probe_pallas3.py (4) time the
bench's phases and count: ``python -m kmer_tpu_torch bench``.
"""

from __future__ import annotations

import torch

from . import capability, copies, rates
from .common import Record

FAMILIES = {"capability": capability, "rates": rates, "copies": copies}


def run_all(device: torch.device | str, only: str | None = None,
            small: bool = False, echo=print) -> list[Record]:
    """Runs the families (or the one named ``only``), echoing each
    probe's line as it finishes; returns the records."""
    device = torch.device(device)
    records = []
    for name, family in FAMILIES.items():
        if only not in (None, name):
            continue
        echo(f"== {name} ==")
        for rec in family.run(device, small=small):
            echo(rec.line())
            records.append(rec)
    return records
