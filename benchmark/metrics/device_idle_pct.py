"""Device: the share of the traced window in which no kernel, copy or
memset runs on the card (the union of the trace's device intervals)."""


def read(run):
    lo, hi = run.trace.window
    busy = run.trace.busy_us()
    if hi <= lo or not busy:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))
