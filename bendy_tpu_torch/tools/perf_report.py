"""The tracer's FP32 utilisation per scene class on the card.

Counterpart of the reference's ``tools/perf_report.py`` (its VPU report):

  ops per lane-iteration  the operations of one iteration of the plain
                          loop (``ops/wavefront.trace_core``, the loop the
                          kernel runs), counted on the CPU under a
                          ``TorchDispatchMode`` (:func:`loop_body_ops`);
  thread-iterations/s     measured on the card: the tracer's launches on
                          the Renderer's lanes between CUDA events, then
                          each launch's per-thread loop lengths
                          (:func:`measure_iters_per_sec`);
  utilisation             sustained ops/s (their product) against the
                          card's FP32 issue rate at the SM clock read
                          during the run, as a range, and against the FP32
                          ceiling kernel 2 measures (``tools/vpu_peak``).

Op-count conventions (the reference's, ``tools/perf_report.py:20-31``):
every elementwise arithmetic, compare, bitwise, select or convert op counts
1 per output element; transcendentals count 1; views, layout ops and
allocations count 0; reductions count 1 per input element; a matrix
product counts 2·M·K·N in a column of its own (0 here: the port's dense
grid is a gather). Two columns the reference has no use for are kept out
of the count: the ``& 0xFFFFFFFF`` masks that only emulate u32 words on
int64 tensors (the kernel's words are ``uint32_t``, so it never issues
them), and table loads and stores (``index``, ``gather``, ``index_put``),
which are memory operations, not FP32 issue. The 16-bit halves of a u32
product (``utils/rng._mul32``) stay in the count, a few tens of operations
a lane-iteration where the kernel issues one multiply.

What the count means on a GPU. The plain loop steps every lane every
iteration under masks, so it counts both sides of every branch, as the
TPU issues them. A warp issues both sides only where its threads diverge,
so the figure is the work of a warp whose threads take every branch; the
utilisation it gives is an upper estimate of the issue the kernel needs.
On the BVH paths the count follows the kernel's route, the plain walk
(``ops/bvh.nearest_hit_bvh_plain``), stepped in lockstep over one warp's
32 lanes as a diverged warp steps, not the CPU route's sweep.

How the loop is counted, not its set-up: two runs over the same 32 lanes
(one warp of the Renderer's lanes, from the middle of the image) at 1 and
2 samples (more where the longer run is no longer), whose loops run
exactly ``ceil(max lane_iters / PENDING_CHECK) · PENDING_CHECK``
iterations (the termination test runs every ``PENDING_CHECK`` iterations),
or the loop cap ``cfg.max_iters(samples)`` where that comes first. The set-up and the fold after the loop are the
same in both runs, so the difference of the two counts over the
difference of the two loops' iterations is the count of one iteration,
exact where the loop has no data-dependent Python branch (all but the
BVH walk, where it is the mean over the extra iterations). Per
lane-iteration is that over the 32 lanes.

On the card an issued thread-iteration is one of 32 × the slowest thread's
loop length of every warp (``tools.rays_per_warp_issue_slot``'s slots),
the GPU's counterpart of the reference's blocks × lanes: threads are lanes
on the lane-loop paths and (lane, sample) items on the per-item ones; a
live thread-iteration is one of a thread's own loop length. Sustained
ops/s is the live thread-iterations' rate times the count: a thread that
has finished issues nothing in the slots its warp still runs (on the TPU
a masked lane does execute, so the reference multiplies by its issued
slots). The product over the issued slots is kept beside it
(``sustained_ops_per_sec_issued``); on the march-dominated per-item paths
it passes the FP32 issue rate, which shows how far the every-branch count
overstates a march step. The tracer is built ``--fmad=false``, so only its
explicit ``fmaf`` calls fuse: ``fp32_utilization_lo`` assumes every
operation pairs into an FMA, ``_hi`` that none does.

    python3 -m bendy_tpu_torch.tools.perf_report [scene ...] [--write]

The scenes default to cornell; ``--write`` writes docs/perf_report_torch.json
(with the card's name and power limit, the commit and the SM clock) and
prints a markdown table. It raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bendy_tpu_torch.utils.rng import MASK32

FP32_LANES_PER_SM = 128  # Hopper: 4 partitions x 32 FP32 lanes
COUNT_LANES = 32  # one warp of lanes
OUT_JSON = "docs/perf_report_torch.json"
# the reference's per-scene configs (perf_report.py:252-257); the rest run Config()
SCENE_CONFIG_KW = {
    "cloud_field": {"max_bounces": 4},
    "mass_cluster": {"max_bounces": 2},
}

ZERO_COST = {
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "t", "transpose", "permute",
    "squeeze", "unsqueeze", "slice", "select", "as_strided", "alias", "detach", "clone",
    "copy", "copy_", "cat", "stack", "empty", "empty_like", "new_empty", "empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones", "full", "full_like",
    "new_full", "arange", "scalar_tensor", "lift_fresh", "lift_fresh_copy",
    "_local_scalar_dense", "split", "split_with_sizes", "unbind", "chunk", "repeat",
    "repeat_interleave", "fill_", "zero_", "_to_copy_same_dtype",
}
REDUCES = {"sum", "any", "all", "amax", "amin", "argmax", "argmin", "prod", "mean",
           "count_nonzero", "max", "min"}
LOADS = {"index", "index_select", "gather", "take", "index_put", "index_put_",
         "_index_put_impl_", "scatter", "scatter_"}
MATMULS = {"mm", "bmm", "addmm", "matmul", "mv", "dot", "baddbmm"}


def _numel(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel()
    if isinstance(out, (tuple, list)):
        return sum(_numel(o) for o in out)
    return 0


def _is_mask(args) -> bool:
    return any((isinstance(a, int) and not isinstance(a, bool) and a == MASK32)
               or (isinstance(a, torch.Tensor) and a.dim() == 0 and not a.is_floating_point()
                   and int(a) == MASK32) for a in args[1:])


class OpCounter(TorchDispatchMode):
    """Counts the aten ops that run inside it by the module's conventions:
    ``ops`` (per-element arithmetic), ``masks`` (u32 masks), ``loads``
    (table loads and stores) and ``matmul`` (2·M·K·N)."""

    def __init__(self):
        super().__init__()
        self.ops = self.masks = self.loads = self.matmul = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name == "_to_copy" and out.dtype == args[0].dtype:
            name = "_to_copy_same_dtype"  # a device move, no convert
        if name in ZERO_COST:
            return out
        if name in ("max", "min") and func._overloadname == "other":
            n = _numel(out)  # the elementwise form
        elif name in REDUCES:
            n = args[0].numel()
        else:
            n = _numel(out)
        if name in MATMULS:
            self.matmul += 2 * n * args[-2 if name in ("addmm", "baddbmm") else 0].shape[-1]
        elif name in LOADS:
            self.loads += n
        elif name == "bitwise_and" and _is_mask(args):
            self.masks += n
        else:
            self.ops += n
        return out


def scene_config(scene_name: str, config=None):
    from bendy_tpu_torch.render import Config

    if config is not None:
        return config
    kw = SCENE_CONFIG_KW.get(scene_name)
    return Config() if kw is None else Config(**kw)


def scene_renderer(scene_name: str, config, width: int, height: int, device):
    """(Renderer on ``device``, camera ref) of a scene class (``bench.load``)
    at width × height, in ``config`` or the class's (:func:`scene_config`)."""
    from bendy_tpu_torch.bench import load
    from bendy_tpu_torch.render import Renderer

    scene = load(scene_name)
    cam_ref = scene.find_by_tag("camera")
    scene.get_object(cam_ref).inner.aspect_ratio = width / height
    r = Renderer(scene, scene_config(scene_name, config), device=device)
    r.camera_params(cam_ref)
    return r, cam_ref


def count_lanes(r, cfg, width: int, height: int, spp: int, subsample: int):
    """(pix, sub) of :data:`COUNT_LANES` consecutive lanes of the
    Renderer's order (``bench.renderer_lanes``), from the middle of the
    frame."""
    from bendy_tpu_torch.bench import renderer_lanes

    pix, sub = renderer_lanes(r, cfg, width, height, spp, subsample)
    mid = pix.numel() // 2 // COUNT_LANES * COUNT_LANES
    return pix[mid:mid + COUNT_LANES].clone(), sub[mid:mid + COUNT_LANES].clone()


def loop_body_ops(scene_name: str, width: int = 256, height: int = 256, spp: int = 64,
                  subsample: int = 2, config=None) -> dict:
    """Operations per lane-iteration of the plain loop body on the CPU (the
    module docstring's method and conventions): ``ops_per_lane_iter``,
    ``mask_ops_per_lane_iter`` (u32 masks, not in the count),
    ``load_ops_per_lane_iter`` (table loads and stores, not in the count),
    ``mxu_flops_per_lane_iter`` (0), the two runs' ``samples`` and loop
    ``iterations``, the trace ``cfg``, and the geometry the card measures
    at."""
    from bendy_tpu_torch.ops.bvh import bvh_tables
    from bendy_tpu_torch.ops.trace_kernel import tracer_table
    from bendy_tpu_torch.ops.wavefront import PENDING_CHECK, trace_core
    from bendy_tpu_torch.utils.rng import render_key

    n = max(subsample, 1)
    r, cam_ref = scene_renderer(scene_name, config, width, height, "cpu")
    cfg = r.trace_config(r.config, cam_ref)
    cam = r.camera_params(cam_ref)
    pix, sub = count_lanes(r, cfg, width, height, spp, n)
    bvh = None
    table, counts = tracer_table(r.arrays.host_copy(), cfg)
    if "bvh0" in counts:  # the kernel walks the tree: count the plain walk
        bvh = bvh_tables(table[counts["bvh0"]:], "cpu")

    def run(samples: int) -> tuple[OpCounter, int]:
        counter = OpCounter()
        with counter:
            res = trace_core(r.arrays, cam, render_key(1, 2), pix, sub, width, height, samples,
                             n, cfg, spp_total=spp, bvh=bvh)
        longest = int(res.lane_counts["iters"].max())
        return counter, min(cfg.max_iters(samples), -(-longest // PENDING_CHECK) * PENDING_CHECK)

    (a, n_a) = run(1)
    for samples in (2, 4, 8, 16, 32):
        (b, n_b) = run(samples)
        if n_b > n_a:
            break
    else:
        raise RuntimeError(f"{scene_name}: the loop did not grow with the samples")
    per = (n_b - n_a) * COUNT_LANES
    return {
        "scene": scene_name,
        "ops_per_lane_iter": (b.ops - a.ops) / per,
        "mask_ops_per_lane_iter": (b.masks - a.masks) / per,
        "load_ops_per_lane_iter": (b.loads - a.loads) / per,
        "mxu_flops_per_lane_iter": (b.matmul - a.matmul) / per,
        "samples": (1, samples), "iterations": (n_a, n_b), "lanes": COUNT_LANES,
        "bvh_walk": bvh is not None,
        "cfg": cfg, "config": r.config,
        "width": width, "height": height, "spp": spp, "subsample": n,
    }


def thread_counts(res, lanes: int, spp: int, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """(rays, iters) per thread of a tracer call in launch order: per lane
    on the lane-loop paths, per (lane, sample) item on the per-item ones
    (``count_items``; item = lane·s + j within each launch's chunk of s
    samples, ``split_samples``)."""
    from bendy_tpu_torch.ops.trace_kernel import N_OUT, split_samples

    lc = res.lane_counts
    if "item_iters" not in lc:
        return lc["rays"], lc["iters"]
    sc = split_samples(lanes, spp, N_OUT if cfg.want_aovs else 3)
    parts = [(lc["item_rays"][:, c0:c0 + sc].reshape(-1), lc["item_iters"][:, c0:c0 + sc]
              .reshape(-1)) for c0 in range(0, spp, sc)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def issued(iters: torch.Tensor) -> int:
    """Thread-iterations the warps of 32 consecutive threads issue: 32 ×
    the slowest thread's loop length, summed over the warps (a trailing
    partial warp left out): ``ops/trace_kernel.warp_use``'s second sum."""
    from bendy_tpu_torch.ops.trace_kernel import warp_use

    return int(warp_use(iters)[1])


def measure_iters_per_sec(info: dict, repeats: int = 5, chain: int = 4) -> dict:
    """The reference's protocol (``perf_report.py:145-189``) on the card:
    ``repeats`` regions of ``chain`` chained ``make_tracer(...).words``
    calls at fresh keys on the Renderer's lanes, each region between CUDA
    events, after one untimed call; afterwards, untimed, every timed key
    again with its per-thread counts (the kernel is deterministic per key).
    The median region (by issued thread-iterations/s) gives
    ``warp_iters_per_sec``, ``thread_iters_per_sec`` (issued),
    ``live_thread_iters_per_sec`` (the threads' own loop lengths) and
    ``rays_per_sec``; ``sm_clock_mhz`` is nvidia-smi's median during the
    regions."""
    from bendy_tpu_torch import _build
    from bendy_tpu_torch.bench import renderer_lanes
    from bendy_tpu_torch.ops.trace_kernel import make_tracer
    from bendy_tpu_torch.tools import card_during

    W, H, spp, n = info["width"], info["height"], info["spp"], info["subsample"]
    r, cam_ref = scene_renderer(info["scene"], info["config"], W, H, "cuda")
    cfg = r.trace_config(r.config, cam_ref)
    tracer = make_tracer(r.arrays, W, H, spp, n, cfg)
    pix, sub = renderer_lanes(r, cfg, W, H, spp, n)
    base = int.from_bytes(os.urandom(4), "little") & 0x3FFFFFFF
    tracer.words(r._cam_packed, base, 0, pix, sub)
    torch.cuda.synchronize()
    times = []
    with card_during() as during:
        for i in range(repeats):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for p in range(chain):
                tracer.words(r._cam_packed, base + 1 + chain * i + p, p, pix, sub)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
    regions = []
    for i, dt in enumerate(times):
        slots = live = rays = 0
        for p in range(chain):
            res = tracer(r._cam_packed, base + 1 + chain * i + p, p, pix, sub, count_items=True)
            t_rays, t_iters = thread_counts(res, pix.numel(), spp, cfg)
            slots += issued(t_iters)
            live += int(t_iters.sum(dtype=torch.int64))
            rays += int(t_rays.sum(dtype=torch.int64))
        regions.append((slots / dt, live / dt, rays / dt, dt))
    regions.sort()
    slots_s, live_s, rays_s, dt = regions[len(regions) // 2]
    return {
        "warp_iters_per_sec": slots_s / 32, "thread_iters_per_sec": slots_s,
        "live_thread_iters_per_sec": live_s, "rays_per_sec": rays_s,
        "region_seconds": dt, "region_seconds_all": times, "chain": chain,
        "sm_clock_mhz": during["clocks.sm"], "power_draw_w": during["power.draw"],
        "threads_per_block": _build.TRACE_BLOCK,
    }


def fp32_issue_per_sec(sm_clock_mhz: float) -> float:
    """FP32 lanes issued per second: SMs × 128 FP32 lanes × the SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * FP32_LANES_PER_SM * sm_clock_mhz * 1e6


def report_row(info: dict, m: dict, fma_ops_per_s: float, issue_per_s: float) -> dict:
    """The report's row from the CPU count (``info``), the card's rates
    (``m``), kernel 2's measured FMA ops/s and the FP32 issue rate."""
    ops = info["ops_per_lane_iter"]
    sustained = m["live_thread_iters_per_sec"] * ops
    return {
        "scene": info["scene"],
        "threads_per_block": m["threads_per_block"],
        "ops_per_lane_iter": ops,
        "mask_ops_per_lane_iter": info["mask_ops_per_lane_iter"],
        "load_ops_per_lane_iter": info["load_ops_per_lane_iter"],
        "mxu_flops_per_lane_iter": info["mxu_flops_per_lane_iter"],
        "warp_iters_per_sec": m["warp_iters_per_sec"],
        "thread_iters_per_sec": m["thread_iters_per_sec"],
        "live_thread_iters_per_sec": m["live_thread_iters_per_sec"],
        "mrays_per_sec": m["rays_per_sec"] / 1e6,
        # rays per warp issue slot (tools.rays_per_warp_issue_slot) of the
        # timed calls, per thread
        "occupancy": m["rays_per_sec"] / m["thread_iters_per_sec"],
        "sustained_ops_per_sec": sustained,
        "sustained_ops_per_sec_issued": m["thread_iters_per_sec"] * ops,
        "sm_clock_mhz": m["sm_clock_mhz"],
        "fp32_issue_ops_per_sec": issue_per_s,
        # the true share lies in [lo, hi]: lo if every op fuses into an FMA,
        # hi if none does (the module docstring)
        "fp32_utilization_lo": sustained / (2 * issue_per_s),
        "fp32_utilization_hi": sustained / issue_per_s,
        "measured_fma_ops_per_sec": fma_ops_per_s,
        "fp32_util_vs_measured_peak": sustained / fma_ops_per_s,
        # the tracer issues no tensor-core operation: its dense grid is a
        # gather of 8 corners, where the TPU kernel contracted one-hots on
        # the MXU
        "mxu_utilization": 0.0,
        "count": {k: info[k] for k in ("samples", "iterations", "lanes", "bvh_walk")},
    }


def report(scene_name: str = "cornell", fma_ops_per_s: float | None = None) -> dict:
    """One scene class's row: :func:`loop_body_ops` on the CPU at the
    reference's geometry (256², 64 spp, 2×2 subpixels, ``SCENE_CONFIG_KW``),
    :func:`measure_iters_per_sec` on the card, and kernel 2's FMA ceiling
    (``tools.vpu_peak.measure``, measured here when not given)."""
    from bendy_tpu_torch.tools import vpu_peak
    from bendy_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # raises without a card
    info = loop_body_ops(scene_name)
    m = measure_iters_per_sec(info)
    if fma_ops_per_s is None:
        fma_ops_per_s = vpu_peak.measure("fma")["ops_per_s"]
    return report_row(info, m, fma_ops_per_s, fp32_issue_per_sec(m["sm_clock_mhz"]))


def markdown(rows: list[dict]) -> str:
    """The rows as a markdown table."""
    lines = ["| scene | ops / lane-iter (masks, loads) | occupancy | Mrays/s | warp-iters/s | "
             "sustained ops/s | SM MHz | FP32 util lo–hi | vs kernel 2 |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['scene']} | {r['ops_per_lane_iter']:.1f} ({r['mask_ops_per_lane_iter']:.1f}, "
            f"{r['load_ops_per_lane_iter']:.1f}) | {r['occupancy']:.4f} | "
            f"{r['mrays_per_sec']:.1f} | {r['warp_iters_per_sec']:.4e} | "
            f"{r['sustained_ops_per_sec']:.4e} | {r['sm_clock_mhz']:.0f} | "
            f"{r['fp32_utilization_lo']:.4f}–{r['fp32_utilization_hi']:.4f} | "
            f"{r['fp32_util_vs_measured_peak']:.4f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    from bendy_tpu_torch.tools import provenance, vpu_peak
    from bendy_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scenes", nargs="*", default=["cornell"])
    ap.add_argument("--write", action="store_true", help=f"write {OUT_JSON}, print a table")
    ap.add_argument("--out", default=OUT_JSON)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")  # raises without a card
    t0 = time.time()
    peak = vpu_peak.measure("fma")
    rows = []
    for name in args.scenes:
        rows.append(report(name, peak["ops_per_s"]))
        print(json.dumps(rows[-1]), flush=True)
    if args.write:
        out = {"rows": rows, "fma_peak": {k: peak[k] for k in (
            "ops_per_s", "ms", "iters", "sm_clock", "share_of_peak", "share_at_clock")},
            "_meta": {**provenance(dev), "seconds": time.time() - t0}}
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
        print(markdown(rows))
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
