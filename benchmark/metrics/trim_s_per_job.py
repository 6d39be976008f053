"""Trim to host (``ops.wide.WideCounts.trim``, ``to_numpy``): seconds a
job, from the benchmark's own span around the two calls (host clock),
summed over the window's jobs and divided by their number."""


def read(run):
    if not run.jobs:
        return None
    return sum(j["trim_s"] for j in run.jobs) / len(run.jobs)
