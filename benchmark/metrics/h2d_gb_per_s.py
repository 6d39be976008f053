"""Upload (``pipeline._upload``: a wire batch, pageable, to the card):
GB a second of the copies' device time.

The bytes of the wire uploaded in the trace's ``upload`` ranges (the
shape of each range's ``aten::to``, int32 words), over the summed device
time of the copies launched inside them (``benchmark.program_spans``).
None without the ranges or the copies.
"""

from benchmark import program_spans


def read(run):
    return program_spans.copy_gb_per_s(run.trace, "upload")
