"""Tools of the port, counterparts of the reference's ``tools/``.

    vpu_peak.py         the FP32 ceiling: the FMA-chain kernel
                        (csrc/probes.cu, replaces tools/vpu_peak.py:85)
    mxu_shape_probe.py  the tensor-core ceiling at the brick-fetch shape:
                        the bf16 dot-chain kernel (csrc/probes.cu,
                        replaces tools/mxu_shape_probe.py:110)
    fidelity.py         MSE-vs-spp of the port's renders against the C++
                        oracle (docs/fidelity_torch.json)
    perf_report.py      the tracer's FP32 utilisation per scene class
                        (docs/perf_report_torch.json)
    block_sweep.py      the render pass per threads per block and lane
                        order (docs/block_sweep_torch.json)
    phase_probe.py      the tracer's time split by phase, through a stub
                        build of csrc/trace_surface.cu
                        (docs/phase_probe_torch.json)
    prim_scaling.py     Mrays/s against primitive count on the sweep and
                        the BVH walk (docs/prim_scaling_torch.json)
    dispatch_probe.py   chained passes against one CUDA graph of them
                        (docs/dispatch_probe_torch.json)
    checkout_ab.py      one card call over several checkouts, in turns

The probes have a plain PyTorch version of their function, ``measure(...)``
and a ``main()`` that prints one JSON line:

    python3 -m bendy_tpu_torch.tools.vpu_peak [--rows R] [--iters N]
    python3 -m bendy_tpu_torch.tools.mxu_shape_probe [--iters N] [--ns 1024,2048]
    python3 -m bendy_tpu_torch.tools.fidelity [--scenes cornell ...] [--device cpu]
    python3 -m bendy_tpu_torch.tools.perf_report [scene ...] [--write]
    python3 -m bendy_tpu_torch.tools.block_sweep [scene ...] [--threads 64 128 256]
    python3 -m bendy_tpu_torch.tools.phase_probe [--scene cornell ...] [--write]
    python3 -m bendy_tpu_torch.tools.prim_scaling [--counts 8 16 ...]
    python3 -m bendy_tpu_torch.tools.dispatch_probe [--scene cornell ...]

The probes, perf_report, block_sweep, phase_probe, prim_scaling and
dispatch_probe measure on the card and raise without one; the fidelity
tool renders on the card unless ``--device cpu``. Below: the timing
helpers they and ``chip_smoke.py`` share, the occupancy arithmetic and the
provenance a result file records.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


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


def graph_ms(fn, calls: int = 20, replays: int = 7) -> tuple[float, float, float]:
    """(median, min, max ms per call) of ``calls`` calls of ``fn`` captured
    in one CUDA graph, over ``replays`` replays, each between its own CUDA
    events, after one untimed call and one untimed replay: the device time
    of work too short for CUDA events around one call, which would time
    the host's launch overhead instead (a replay launches every captured
    kernel with no host work between them)."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times), min(times), max(times)


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


def rays_per_warp_issue_slot(rays, iters) -> float:
    """The tracer's occupancy: the sum of per-thread rays over 32 x the
    slowest thread's loop length, summed over the warps of 32 consecutive
    threads (``rays``, ``iters``: per-thread counts, such as a call's
    ``TraceSums.lane_counts``; a trailing partial warp is left out). The
    GPU counterpart of the reference's rays over issue slots
    (``tools/perf_report.py:239``): 1.0 when every thread of a warp runs
    as many iterations as the warp, each tracing a ray. Both sums are
    ``ops/trace_kernel.warp_use``'s, the rays' thread sum over its issued
    iterations."""
    from bendy_tpu_torch.ops.trace_kernel import warp_use

    return int(warp_use(rays)[0]) / max(int(warp_use(iters)[1]), 1)


def commit() -> str | None:
    """The commit this checkout runs: git's HEAD, with "+changes" when the
    working tree differs from it; in a copy without git history, the
    ``BENDY_COMMIT`` environment variable the caller sets, else None."""
    try:
        head = subprocess.run(["git", "-C", REPO, "rev-parse", "HEAD"], capture_output=True,
                              text=True, timeout=60)
        dirty = subprocess.run(["git", "-C", REPO, "status", "--porcelain", "--", "."],
                               capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        head = None
    if head is not None and head.returncode == 0:
        return head.stdout.strip() + ("+changes" if dirty.stdout.strip() else "")
    return os.environ.get("BENDY_COMMIT")


def provenance(device) -> dict:
    """What a result file records of where it ran: the device and, on a
    card, its name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (card
    0, :func:`card`); and the commit (:func:`commit`)."""
    import torch

    dev = torch.device(device)
    out = {"device": str(dev)}
    if dev.type == "cuda":
        c = card()
        out["card"] = f"{c['name']}, {c['power.limit']}"
        out["kind"] = torch.cuda.get_device_name(dev)
    out["commit"] = commit()
    return out


def write_json(path: str, body: dict, device, **meta) -> None:
    """``body`` as JSON at ``path``, with ``_meta``: :func:`provenance`
    of ``device`` (the card's name and power limit) and ``meta``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({**body, "_meta": {**provenance(device), **meta}}, f, indent=2)
