"""Routing probe (``pipeline.file_batch_feed``'s first chunk, read and
parsed on the main thread to pick the width and the route): seconds a
job.

The trace's ``feed.probe`` ranges on the window's thread, summed, over
the window's ``bench.job`` ranges.  None where the program has no such
range (a packed feed has no probe).
"""


def read(run):
    t = run.trace
    jobs = t.named("bench.job")
    probes = [r for r in t.named("feed.probe")
              if t.main_tid is None or r.tid == t.main_tid]
    if not jobs or not probes:
        return None
    return sum(r.end - r.ts for r in probes) * 1e-6 / len(jobs)
