"""Host feed against the device: the share of the window's device-idle
time in which the feeder thread is at work (reading, parsing or packing:
``benchmark.program_spans.feeder_work``, placed on the trace's clock).

High where the device waits on the feed; low where it waits on something
else (the trim, the routing probe) or the feed overlaps the device.  None
without the program's records or without a device operation.
"""

from benchmark import program_spans


def read(run):
    t = run.trace
    if not t.busy():
        return None
    work = program_spans.merged(program_spans.feeder_work(t))
    gaps = t.idle_gaps()
    idle = sum(b - a for a, b in gaps)
    if not work or not idle:
        return None
    return 100.0 * program_spans.overlap_us(gaps, work) / idle
