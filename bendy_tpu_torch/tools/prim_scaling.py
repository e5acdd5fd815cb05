"""Mrays/s and first-call time against primitive count, per sweep route.

Counterpart of the reference's ``tools/prim_scaling.py`` (its unrolled
megakernel against its looped sweep). The port's two routes are the
run-time sweep over every primitive row (``"sweep"``) and the BVH walk
(``"bvh"``: the tracer's BVH instantiations, ``ops/bvh.py``), which
``render.LOOP_SWEEP_THRESHOLD`` chooses between by the primitive count;
here each route is forced through ``TraceConfig.looped_sweep``, as the
reference's ``force_looped`` forces its own (in flat space
``ops/bvh.uses_bvh`` follows it). The workload is the reference's:
``build_prim_grid(n)`` at 256², 64 spp, no subpixels, ``Config(max_bounces=4)``.

Per row (:func:`measure`), the reference's protocol: ``first_call_s``, the
time to the first film (the BVH build, the kernels' build unless it is
cached, one pass; the reference's ``compile_s``), then 5 regions of 4
chained passes at fresh seeds, ``mrays_median`` and ``mrays_best``; and,
beyond the reference, the tracer alone (``kernel_ms``: the median, min and
max of 7 calls with fresh seeds, ``tools.cuda_ms_median``). The reference's
``pallas`` field (which kernel ran) is ``bvh`` here: whether the launches
walked a tree (a table whose tree does not fit the walk runs the sweep).

    python3 -m bendy_tpu_torch.tools.prim_scaling [--counts 8 16 ...]
        [--out docs/prim_scaling_torch.json]

Both routes run at every count (default :data:`COUNTS`, the union of the
reference's two sets and 192, the threshold); the result states the
crossover (:func:`crossover`). It raises without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

COUNTS = (8, 16, 32, 64, 128, 192, 256, 512)
ROUTES = ("sweep", "bvh")
W = H = 256
SPP = 64
MAX_BOUNCES = 4
REGIONS = 5  # timed regions of PASSES chained passes
PASSES = 4
KERNEL_REPEATS = 7
OUT_JSON = "docs/prim_scaling_torch.json"


def forced_renderer(n: int, route: str, width: int, height: int, device):
    """(Renderer of build_prim_grid(n) at width × height whose trace
    configuration forces ``route``, camera ref)."""
    from bendy_tpu_torch import Config, Renderer, build_prim_grid

    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; the routes are {list(ROUTES)}")
    scene = build_prim_grid(n)
    cam_ref = scene.find_by_tag("camera")
    scene.get_object(cam_ref).inner.aspect_ratio = width / height
    r = Renderer(scene, Config(max_bounces=MAX_BOUNCES), device=device)
    orig = r.trace_config

    def trace_config(cfg, camera_ref=None):
        return dataclasses.replace(orig(cfg, camera_ref), looped_sweep=route == "bvh")

    r.trace_config = trace_config
    return r, cam_ref


def measure(n: int, route: str, device="cuda", width: int = W, height: int = H,
            spp: int = SPP, regions: int = REGIONS, seed: int | None = None) -> dict:
    """One row: build_prim_grid(n) through the Renderer on ``route`` (the
    module docstring's protocol; ``kernel_ms`` only on a card), its passes
    keyed from ``seed`` (default: a fresh one)."""
    import torch

    from bendy_tpu_torch import DeviceFilm, RenderConfig, Subsample
    from bendy_tpu_torch.bench import renderer_lanes
    from bendy_tpu_torch.ops.trace_kernel import make_tracer, walks_bvh
    from bendy_tpu_torch.tools import cuda_ms_median

    r, cam_ref = forced_renderer(n, route, width, height, device)
    dev = r.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rc = RenderConfig(samples=spp, subsample=Subsample(1))
    base = int.from_bytes(os.urandom(4), "little") & 0x3FFFFFFF if seed is None else seed
    t0 = time.perf_counter()
    film = DeviceFilm(width, height, device=dev)
    r.render(cam_ref, rc, film, seed=base)
    sync()
    first_call_s = time.perf_counter() - t0
    mrays, rays, films = [], [], [film]
    for i in range(regions):
        film = DeviceFilm(width, height, device=dev)
        r.rays_traced = 0
        t0 = time.perf_counter()
        for p in range(PASSES):
            r.render(cam_ref, rc, film, seed=base + 1 + PASSES * i + p)
        sync()
        dt = time.perf_counter() - t0
        rays.append(r.rays_traced)  # the rays fetch: untimed
        mrays.append(rays[-1] / dt / 1e6)
        films.append(film)
    cfg = r.trace_config(r.config, cam_ref)
    row = {
        "n_field_prims": n,
        "spheres": r.arrays.n_spheres,
        "boxes": r.arrays.n_boxes,
        "trace_rects": r.arrays.n_trace_rects,
        "route": route,
        "looped_sweep": cfg.looped_sweep,
        "bvh": walks_bvh(r.arrays, cfg),
        "first_call_s": first_call_s,
        "mrays_median": statistics.median(mrays),
        "mrays_best": max(mrays),
        "rays_regions": rays,
        "kernel_ms": None, "kernel_ms_min": None, "kernel_ms_max": None,
        "device": str(dev),
    }
    if dev.type == "cuda":
        tracer = make_tracer(r.arrays, width, height, spp, 1, cfg)
        pix, sub = renderer_lanes(r, cfg, width, height, spp, 1)
        _, ms, lo, hi = cuda_ms_median(
            lambda i: tracer.words(r._cam_packed, base + 100 + i, 0, pix, sub), KERNEL_REPEATS)
        row.update(kernel_ms=ms, kernel_ms_min=lo, kernel_ms_max=hi)
    row["_films"] = films  # the first pass's film, then each region's (not written)
    return row


def crossover(rows: list[dict], key: str = "mrays_median") -> int | None:
    """The smallest count from which on the BVH route beats the sweep at
    every larger count by ``key`` (Mrays/s, higher is better; a key ending
    in ``_ms``, lower is better), or None where it never does."""
    by = {(row["route"], row["n_field_prims"]): row[key] for row in rows}
    counts = sorted({n for route, n in by if (("sweep", n) in by and ("bvh", n) in by)})
    lower = key.endswith("_ms")
    wins = [(by["bvh", n] < by["sweep", n]) if lower else (by["bvh", n] > by["sweep", n])
            for n in counts]
    best = None
    for n, win in reversed(list(zip(counts, wins))):
        if not win:
            break
        best = n
    return best


def main(argv=None) -> int:
    from bendy_tpu_torch.tools import write_json
    from bendy_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--counts", type=int, nargs="+", default=list(COUNTS))
    ap.add_argument("--out", default=OUT_JSON)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")  # raises without a card
    t0 = time.time()
    rows = []
    for route in ROUTES:
        for n in args.counts:
            row = measure(n, route, dev)
            row.pop("_films")
            rows.append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    cross = {"crossover_mrays_median": crossover(rows, "mrays_median"),
             "crossover_kernel_ms": crossover(rows, "kernel_ms")}
    write_json(args.out, {"workload": f"{W}x{H}@{SPP}spp mb={MAX_BOUNCES} build_prim_grid(n), "
                                      "both routes", "rows": rows, **cross},
               dev, seconds=time.time() - t0)
    print(json.dumps(cross))
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
