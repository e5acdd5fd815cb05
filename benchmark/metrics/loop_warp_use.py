"""The tracer's thread-loop iterations over the iterations its warps issue
(32 × each warp's longest loop), in %, over the traced window's passes,
from the program's own counters (benchmark/program_counters.py): how full
the warps of the thread loop run. Counted on the device by the pass's fold
kernels (per-item launches) or its accumulate kernel (one thread a lane);
none where the program keeps no counters."""

from benchmark import program_counters


def read(r):
    if r.trace is None:
        return None
    return program_counters.warp_use(program_counters.recorded())
