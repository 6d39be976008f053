"""Trim to host (``WideCounts.trim`` / ``CountTable.trim``: the stacked
live rows, to pageable host memory): GB a second of the copy's device
time.

The bytes of the rows copied in the trace's ``trim.copy`` ranges (the
shape of each range's ``aten::to``, int64 lanes), over the summed device
time of the copies launched inside them (``benchmark.program_spans``).
None without the ranges or the copies.
"""

from benchmark import program_spans


def read(run):
    return program_spans.copy_gb_per_s(run.trace, "trim.copy")
