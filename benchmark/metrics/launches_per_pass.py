"""Device kernels the window ran per pass, counted from the profiler's
kernel events (not from the program's launch counters)."""


def read(r):
    if r.trace is None or not r.window.passes:
        return None
    n = len(r.trace.kernels())
    return n / r.window.passes if n else None
