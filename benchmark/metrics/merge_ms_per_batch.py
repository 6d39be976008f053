"""Fold merge (``ops.wide.table_groups``, ``live_rows``, ``merge_groups``,
``fit_groups``): device milliseconds a batch.

The summed time of the device operations (kernels, copies, memsets)
launched in the fold's ``compact`` and ``merge`` ranges over the window,
divided by the window's batches (``StatsCounters.batches``).
"""


def read(run):
    ops = run.trace.launched_in(("compact", "merge"))
    if not ops or not run.batches:
        return None
    return sum(d.end - d.ts for d in ops) * 1e-3 / run.batches
