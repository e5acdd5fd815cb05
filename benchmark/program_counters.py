"""The program's own counters, for the readers of a traced run.

The port counts, only while a profiler records, the tracer's warp use on the
device (``bendy_tpu_torch.telemetry.counters()``, beside the spans that
``benchmark/program_spans.py`` reads): ``loop_thread_iters``, the thread
loop's iterations summed over the tracer's threads, and
``loop_issued_iters``, the iterations its warps of 32 consecutive threads
issue, 32 × each warp's longest loop. In a ``--trace 1`` run they hold the
window's passes alone: the warm-up runs before the profiler starts.

Every function gives None where there is nothing to read: a program without
the counters (an older checkout), or no profiled pass.
"""

from __future__ import annotations


def recorded():
    """The program's counters (a dict of name to int), or None where the
    program keeps none."""
    try:
        from bendy_tpu_torch import telemetry
    except ImportError:
        return None
    counters = getattr(telemetry, "counters", None)
    return None if counters is None else counters()


def warp_use(counters) -> float | None:
    """Thread-loop iterations over the iterations the warps issued, in %, or
    None without an issued iteration."""
    if not counters or counters.get("loop_issued_iters", 0) <= 0:
        return None
    return 100.0 * counters["loop_thread_iters"] / counters["loop_issued_iters"]
