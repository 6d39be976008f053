"""Host feed, feeder side (``io.ingest``, ``native``, the feed's packing,
``pipeline._Feeder``): the file's bytes the feeder thread reads a second
of its own work.

The program's span records (``benchmark.program_spans``): the feeder
thread's ``feed.read`` bytes in the window, over the self time of its
``feed.read``, ``feed.parse`` and ``feed.pack`` spans (its waits on a
full queue, ``feed.put``, left out).  GB is 1e9 bytes.  None without the
records, or where the feeder read nothing (a packed feed).
"""

from benchmark import program_spans


def read(run):
    work = program_spans.feeder_work(run.trace)
    nbytes = sum(s.nbytes for s in work if s.name == "feed.read")
    # the work spans do not nest, so their union is their self time
    busy_us = sum(b - a for a, b in program_spans.merged(work))
    if not nbytes or not busy_us:
        return None
    return nbytes / 1e9 / (busy_us * 1e-6)
