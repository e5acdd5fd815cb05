"""Device time of the tracer and fold kernels per pass, by kernel name, in
ms, from the profiler's kernel events in the window."""

TRACER_KERNELS = ("trace", "fold")


def read(r):
    if r.trace is None or not r.window.passes:
        return None
    t = r.trace.kernel_s(TRACER_KERNELS)
    return t / r.window.passes * 1e3 if t > 0 else None
