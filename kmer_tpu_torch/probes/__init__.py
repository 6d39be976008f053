"""The probe scripts, ported: what the TPU probes in ``scripts/`` computed
inside ``pl.pallas_call``, run through the port's hand-written probe
kernels (``kernels/tile_gather``, ``tile_stages``, ``row_sort``,
``segment_copy``) and held against their plain PyTorch versions; the
sort-floor probes; the sample-partition count engine; the matrix-unit
rates; and the phase-decomposition probes of the engine's own path.

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
  ``count_windows`` on the same keys;
* ``matmul``: the matrix-unit rates of probe_pallas.py (d), an int8
  one-hot permute, and probe_pallas2.py (h), a bf16 batched product, on
  the tensor cores through library products.

The phase probes (``common.PhaseRecord``; each times a part of the
engine's own path at its script's workload, and checks what it counted):

* ``feed``: probe_feed.py, the native parser and the file feed;
* ``device_phases``: probe_phases.py, extraction, sort and segment counts
  alone, and three primitive rates;
* ``count_phases``: probe_r5b.py, probe_r5c.py and probe_r5e.py,
  ``count_file``'s feed, upload, fold compute and trim;
* ``read_stream``: probe_r5a.py, ``count_read_stream`` split up, and a
  pipelined fold;
* ``fold_step``: probe_step.py and probe_r5d.py, the stream step's parts
  and the merge cadence;
* ``stream_loop``: probe_r4c.py and probe_r4d.py, the stream loop with and
  without checkpoint writes;
* ``checkpoint``: probe_r4b.py, one checkpoint write split up;
* ``distcount_step``: probe_r5g.py, the distcount step on one rank and on
  two gloo ranks, with the staged all_to_all's legs.

probe_pallas.py (e) and probe_pallas3.py (4) time the bench's phases and
count: ``python -m kmer_tpu_torch bench``.
"""

from __future__ import annotations

import tempfile

import torch

from ..device import resolve_device
from . import (
    capability, checkpoint, copies, count_phases, device_phases,
    distcount_step, feed, fold_step, matmul, partition, rates, read_stream,
    sorting, stream_loop)
from .common import PhaseRecord, Record

FAMILIES = {"capability": capability, "rates": rates, "copies": copies,
            "sorting": sorting, "partition": partition, "matmul": matmul,
            "feed": feed, "device_phases": device_phases,
            "count_phases": count_phases, "read_stream": read_stream,
            "fold_step": fold_step, "stream_loop": stream_loop,
            "checkpoint": checkpoint, "distcount_step": distcount_step}
# the phase families in the order chip_smoke.py runs them, with the count
# path's kernels each launches on a card (the stream loop feeds raw codes:
# its steps make their keys with codes_keys)
PHASE_KERNELS = {
    "feed": (),
    "device_phases": ("wire_keys", "segment_counts"),
    "count_phases": ("wire_keys", "segment_counts"),
    "read_stream": ("wire_keys", "segment_counts"),
    "fold_step": ("wire_keys", "codes_keys", "segment_counts"),
    "stream_loop": ("codes_keys", "segment_counts"),
    "checkpoint": (),
    "distcount_step": ("wire_keys", "segment_counts"),
    "matmul": (),
}


def run_all(device: torch.device | str,
            only: str | tuple[str, ...] | None = None, small: bool = False,
            echo=print) -> list[Record | PhaseRecord]:
    """Runs the families (or the one named ``only``, or those of a tuple),
    echoing each probe's line as it finishes; returns the records.  Every
    family gets one temporary work directory; those that write no files
    ignore it."""
    device = resolve_device(device)
    names = FAMILIES if only is None else (only,) if isinstance(
        only, str) else only
    records = []
    with tempfile.TemporaryDirectory(prefix="kmer_probes_") as tmp:
        for name, family in FAMILIES.items():
            if name not in names:
                continue
            echo(f"== {name} ==")
            for rec in family.run(device, small=small, workdir=tmp):
                echo(rec.line())
                records.append(rec)
    return records
