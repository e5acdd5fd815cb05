"""Ceiling probes of the card, counterparts of the reference's ``tools/``.

    vpu_peak.py         the FP32 ceiling: the FMA-chain kernel
                        (csrc/probes.cu, replaces tools/vpu_peak.py:85)
    mxu_shape_probe.py  the tensor-core ceiling at the brick-fetch shape:
                        the bf16 dot-chain kernel (csrc/probes.cu,
                        replaces tools/mxu_shape_probe.py:110)

Each has a plain PyTorch version of its function, ``measure(...)`` and a
``main()`` that prints one JSON line:

    python3 -m bendy_tpu_torch.tools.vpu_peak [--rows R] [--iters N]
    python3 -m bendy_tpu_torch.tools.mxu_shape_probe [--iters N] [--ns 1024,2048]

Both measure on the card and raise without one.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import threading
import time


def cuda_ms(fn, repeats: int = 1, warmup: int = 0, warm_s: float = 0.0):
    """(last result, mean ms per call) of ``fn`` timed with CUDA events,
    after ``warmup`` untimed calls (first-call set-up such as table uploads)
    and more untimed calls until ``warm_s`` seconds have passed (the SM
    clock ramps up again after a stretch of light load)."""
    import torch

    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    while time.perf_counter() - t0 < warm_s:
        fn()
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / repeats


def cuda_ms_median(fn, repeats: int = 7, warmup: int = 1, warm_s: float = 0.5):
    """(last result, median, min, max ms) of ``repeats`` calls ``fn(i)``,
    i = 1..repeats, each timed alone between its own pair of CUDA events
    so that ``fn`` can take a fresh seed from ``i`` (bench.py's
    timed_render protocol), after ``warmup`` untimed calls ``fn(0)`` and
    more until ``warm_s`` seconds have passed. An untimed ``fn(0)`` goes
    ahead of each timed call, so that the card is busy while the host
    prepares it, as in a chain of passes: the events then time the card's
    work and not the host's launch overhead."""
    import statistics

    import torch

    t0 = time.perf_counter()
    for _ in range(warmup):
        fn(0)
    torch.cuda.synchronize()
    while time.perf_counter() - t0 < warm_s:
        fn(0)
        torch.cuda.synchronize()
    times = []
    for i in range(1, repeats + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn(0)
        start.record()
        out = fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return out, statistics.median(times), min(times), max(times)


def card() -> dict:
    """The card's name, power limit, SM clock and power draw, as nvidia-smi
    reads them now."""
    q = "name,power.limit,clocks.sm,power.draw"
    line = subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={q}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return dict(zip(q.split(","), (v.strip() for v in line.split(","))))


@contextlib.contextmanager
def card_during():
    """Yields a dict that, when the block ends, holds the medians of the SM
    clock (``clocks.sm``, MHz) and power draw (``power.draw``, W) that
    nvidia-smi read while the block ran, and ``samples``, their count. A
    thread of this process queries nvidia-smi back to back from the block's
    start to its end and is joined on exit."""
    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            line = subprocess.run(
                ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, check=True, timeout=60,
            ).stdout
            samples.append([float(v) for v in line.split(",")])

    out = {}
    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join(timeout=120)
        out["samples"] = len(samples)
        for i, key in enumerate(("clocks.sm", "power.draw")):
            out[key] = statistics.median(s[i] for s in samples) if samples else None
