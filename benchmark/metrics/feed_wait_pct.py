"""Host feed (``pipeline.file_batch_feed``, ``io.ingest``, ``native``,
``pipeline._Feeder``): the share of the jobs' host time outside the
fold's ranges and the trim span.

That is the consumer waiting for its next batch, and before the first
the routing probe, derived: the program has no span of its own around
the feed.  Sums over the traced window's ``bench.job`` spans.
"""

FOLD = ("extract", "count", "compact", "merge", "spill", "merge_runs",
        "ckpt", "bench.trim")


def read(run):
    t = run.trace
    jobs = t.named("bench.job")
    if not jobs:
        return None
    busy = t.union_us(FOLD, tid=t.main_tid)
    total = outside = 0.0
    for j in jobs:
        covered = sum(max(0.0, min(b, j.end) - max(a, j.ts)) for a, b in busy)
        total += j.end - j.ts
        outside += (j.end - j.ts) - covered
    return 100.0 * outside / total if total else None
