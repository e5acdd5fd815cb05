"""The share of the traced window of a chained cell in which no device
operation ran, in %."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
