"""Host feed, consumer side (``pipeline._next``): the share of the jobs'
time the main thread waits on the feeder's queue for its next batch.

The trace's ``queue.wait`` ranges on the window's thread, over the
window's ``bench.job`` ranges.  None where the program has no such range.
"""


def read(run):
    t = run.trace
    jobs = t.named("bench.job")
    waits = t.union_us(("queue.wait",), tid=t.main_tid)
    if not jobs or not waits:
        return None
    total = waited = 0.0
    for j in jobs:
        total += j.end - j.ts
        waited += sum(max(0.0, min(b, j.end) - max(a, j.ts))
                      for a, b in waits)
    return 100.0 * waited / total if total else None
