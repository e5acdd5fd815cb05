"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration into the program, warms up every shape of
its traffic, drives the traffic for ``--seconds`` (under the profiler with
``--trace 1``), then holds the passes it kept to the plain reference. The
last line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` (and ``breakdown`` when traced), and
last ``checks``, each compared number with its limit; the same numbers are
the last lines of standard error. Without a CUDA card, or with fewer cards
than the cell asks for, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "bendy_tpu")


@dataclass
class Readings:
    """What one run saw, for the metric readers."""

    plan: object  # traffic.Plan
    setup_s: float
    scene_setup_s: float
    window: object  # drive.Window
    trace: object  # trace.Trace, or None
    refs: list  # check.RefPass of the verified passes
    scene: dict  # n_sph, n_rct, n_box, n_mass, floats (the reference's compile)

    def per_pass_counts(self) -> dict:
        """The reference's work counts per pass over the whole image: the
        mean over verified passes, each scaled up from its pixel sample."""
        total = self.plan.width * self.plan.height
        out = dict(rays=0.0, near_steps=0.0, vol_events=0.0)
        for r in self.refs:
            scale = total / r.pixels.numel()
            for k in out:
                out[k] += r.counts[k] * scale / len(self.refs)
        return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def run_cell(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             program_cls=None) -> tuple[dict, list]:
    """(result object, check lines) of one run of ``cell``."""
    import torch

    from . import check, drive, spec, trace
    from .program import Program
    from .traffic import plan as make_plan

    program_cls = program_cls or Program
    dev = torch.device(device)
    plan = make_plan(cell.mix, seed)
    t_context = time.perf_counter()
    torch.zeros(1, device=dev).tolist()  # the CUDA context, outside the scene's span
    t0 = time.perf_counter()
    program = program_cls(str(cell.scene_path()), cell.config["render"], dev)
    scene_setup_s = time.perf_counter() - t0
    win = drive.measure(program, plan, seconds, traced)
    setup_s = win.setup_end - t_start
    setup_parts = (f"set-up {setup_s:.3f} s: imports {t_context - t_start:.3f}, CUDA context "
                   f"{t0 - t_context:.3f}, scene {scene_setup_s:.3f}, warm-up "
                   f"{win.setup_end - t0 - scene_setup_s:.3f} s")
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    t_read = time.perf_counter()
    tr = trace.read(win.profiler) if win.profiler is not None else None
    t_read = time.perf_counter() - t_read
    win.profiler = None
    for k in win.kept:
        k.before, k.after = k.before.cpu(), k.after.cpu()
        k.rays_before, k.rays_after = k.rays_before.cpu(), k.rays_after.cpu()
    del program
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    verify = check.chosen(win.kept, int(cell.check["verify"]), seed)
    ref = check.Reference(str(cell.scene_path()), cell.config["render"], plan, dev)
    refs = [ref.run(k, check.pixel_sample(plan, cell.check["pixels"], seed, k.index))
            for k in verify]
    t_ref = time.perf_counter() - t_ref
    per_pass = [check.compare(plan, [k], [r]) for k, r in zip(verify, refs)]
    numbers = check.compare(plan, verify, refs)
    limits = cell.check["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}
    correct = bool(verify) and all(c["value"] <= c["limit"] for c in checks.values())
    failed = sum(any(v > limits[k] for k, v in p.items() if k in limits) for p in per_pass)
    arrays = ref.arrays
    scene = dict(n_sph=arrays.n_spheres, n_rct=arrays.n_trace_rects, n_box=arrays.n_boxes,
                 n_mass=arrays.n_masses,
                 floats=sum(t.numel() for t in vars(arrays).values()
                            if isinstance(t, torch.Tensor) and t.is_floating_point()))
    readings = Readings(plan, setup_s, scene_setup_s, win, tr, refs, scene)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"])(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": win.passes, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": cell.chips, "memory_peak_bytes": memory_peak}}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.ops_by_name()[:10],
                               "idle_gaps": tr.idle_by_span()[:10]}
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    lines.insert(0, f"timing: {setup_parts}; window {win.seconds:.3f} s, trace read "
                    f"{t_read:.3f} s, reference {t_ref:.3f} s")
    lines.append(f"check verified passes {[k.index for k in verify]} of {win.passes}; "
                 f"correct {correct}")
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    t = time.perf_counter()
    import torch

    print(f"benchmark: import torch {time.perf_counter() - t:.3f} s", file=sys.stderr)
    from . import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    print(f"benchmark: {args.workload} seed {args.seed} on {card_power_limit()}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
