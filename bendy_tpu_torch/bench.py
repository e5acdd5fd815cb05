"""Headline benchmark of the port: Mrays/s on one card, cornell.json.gz.

Counterpart of the reference's ``bench.py``, rendering through the port's
CUDA tracers. BASELINE.md's target is >= 50 Mrays/s per chip at 256x256 @
64 spp with a 2x2 subpixel grid (256 camera rays a pixel): ``TARGET``, a
target, not a measurement. A "ray" is one alive-lane wavefront iteration:
one scene intersection and shade, a geodesic chord or a march step.

    python3 -m bendy_tpu_torch.bench          # the headline JSON line
    python3 -m bendy_tpu_torch.bench --full   # + every row, into --out

The headline is one JSON line {"metric", "value", "unit", "vs_baseline",
...}; ``--full`` adds the reference's rows (``bench.py:196-349``, less its
TPU-pod projection and the VPU-utilization row) and writes them, with the
card's name and power limit, to ``--out`` (default
``benches_results_torch.json``). Each row carries ``kernel_ms``, the tracer
alone at the row's shape, so the pass glue shows beside ``seconds``.
Without a card :func:`main` raises: it never times the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from bendy_tpu_torch.film import DeviceFilm
from bendy_tpu_torch.ops import trace_kernel
from bendy_tpu_torch.ops.trace_kernel import make_tracer, pass_lanes
from bendy_tpu_torch.render import Config, Renderer, RenderConfig, Subsample
from bendy_tpu_torch.tools import cuda_ms_median, provenance, rays_per_warp_issue_slot

TARGET = 50.0  # Mrays/sec/chip (BASELINE.json)
OCCUPANCY_SEED = 7  # the seed of occupancy's one untimed call (chip_smoke phases 4-12 too)
KERNEL_REPEATS = 7  # timed tracer calls behind kernel_ms, each with a fresh seed
# the launch counts a row records, one per kernel wrapper of the pass
COUNTED = ("trace_surface", "trace_geodesic", "trace_volume", "fold_samples", "accumulate")


def tracer_name(cfg) -> str:
    """The kernel wrapper a trace configuration launches."""
    return ("trace_volume" if cfg.has_volumes else
            "trace_geodesic" if cfg.geodesic else "trace_surface")


def launch_counts() -> dict:
    return {name: getattr(trace_kernel, name).launches for name in COUNTED}


def _seed() -> int:
    # never-before-seen seeds, as the reference's protocol takes them
    return int.from_bytes(os.urandom(4), "little") & 0x7FFFFFFF


def tracer_ms(r: Renderer, cam_ref: int, width: int, height: int, samples: int,
              subsample: int) -> float:
    """The tracer alone over the whole frame's lanes (one call of
    ``make_tracer(...).words``: its launches and, per item, its folds; no
    accumulate): the median ms of KERNEL_REPEATS calls with fresh seeds,
    each between its own CUDA events (``tools.cuda_ms_median``)."""
    n = max(subsample, 1)
    tracer = make_tracer(r.arrays, width, height, samples, n, r.trace_config(r.config, cam_ref))
    pix, sub = pass_lanes(width, height, n * n, 0, r.device)
    base = _seed()
    _, ms, _, _ = cuda_ms_median(lambda i: tracer.words(r._cam_packed, base + i, 0, pix, sub),
                                 KERNEL_REPEATS)
    return ms


def timed_render(scene, width, height, samples, subsample, config=Config(),
                 repeats=7, passes=1, device="cuda"):
    """{'best', 'median', 'seconds_best', 'seconds_median', ...} over
    fresh-seed passes (the reference's ``bench.py:27-76``).

    One warm-up pass, then ``repeats`` timed regions, each of ``passes``
    chained ``Renderer.render`` calls into a fresh :class:`DeviceFilm`, each
    with its own seed, closed by ``film.synchronize()``; the int64 ray
    counter is read after the timed region. seconds_* are per pass (wall /
    passes). Also: ``rays`` (per region), ``seed`` (region i's pass p has
    seed + 1 + i * passes + p), ``launches`` (each wrapper's kernel
    launches over the regions; 0 on the CPU, where the plain versions run),
    ``tracer`` (the wrapper the scene's configuration launches) and, on a
    card, ``kernel_ms`` (:func:`tracer_ms`; None elsewhere).
    """
    cam_ref = scene.find_by_tag("camera")
    scene.get_object(cam_ref).inner.aspect_ratio = width / height
    r = Renderer(scene, config, device=device)
    rc = RenderConfig(samples=samples, subsample=Subsample(subsample))
    base = _seed()
    r.render(cam_ref, rc, DeviceFilm(width, height, device=r.device), seed=base)  # warm-up
    before = launch_counts()
    mrays, secs, rays = [], [], []
    for i in range(repeats):
        film = DeviceFilm(width, height, device=r.device)
        r.rays_traced = 0
        t0 = time.perf_counter()
        for p in range(passes):
            r.render(cam_ref, rc, film, seed=base + 1 + i * passes + p)
        film.synchronize()
        dt = time.perf_counter() - t0
        rays.append(r.rays_traced)  # the rays fetch: untimed
        mrays.append(rays[-1] / dt / 1e6)
        secs.append(dt / passes)
    after = launch_counts()
    return {
        "best": max(mrays),
        "median": statistics.median(mrays),
        "seconds_best": min(secs),
        "seconds_median": statistics.median(secs),
        "rays": rays,
        "seed": base,
        "launches": {k: after[k] - before[k] for k in COUNTED},
        "tracer": tracer_name(r.trace_config(r.config, cam_ref)),
        "kernel_ms": (tracer_ms(r, cam_ref, width, height, samples, subsample)
                      if r.device.type == "cuda" else None),
    }


def occupancy(scene, width=256, height=256, spp=64, sub=2, config=Config(), device="cuda",
              seed=OCCUPANCY_SEED) -> float:
    """Rays per warp issue slot (:func:`tools.rays_per_warp_issue_slot`)
    of one untimed tracer call at the row's shape, key ``render_key(seed,
    0)``, from its ``TraceSums.lane_counts``: the number ``chip_smoke.py``
    phases 4-12 print for the same path and seed."""
    cam_ref = scene.find_by_tag("camera")
    scene.get_object(cam_ref).inner.aspect_ratio = width / height
    r = Renderer(scene, config, device=device)
    r.camera_params(cam_ref)
    n = max(sub, 1)
    pix, lane_sub = pass_lanes(width, height, n * n, 0, r.device)
    res = make_tracer(r.arrays, width, height, spp, n, r.trace_config(r.config, cam_ref))(
        r._cam_packed, seed, 0, pix, lane_sub)
    return rays_per_warp_issue_slot(res.lane_counts["rays"], res.lane_counts["iters"])


def sharded_row(width=256, height=256, spp=64, subsample=2) -> dict:
    """``parallel/mesh.make_kernel_pass_sharded`` on a (1,1) mesh, an NCCL
    world of one in this process (the reference's
    ``sharded_megakernel_row``, ``bench.py:79-142``): its 4-pass-chained
    median rate over 3 regions, the worst deviation from the plain sharded
    pass at the same seed in units of (5e-4 rel + 1e-5), the rays' relative
    difference, the tracer alone, and the launches of the timed passes."""
    import torch.distributed as dist

    from bendy_tpu_torch.parallel import (initialize, make_kernel_pass_sharded, make_mesh,
                                          render_pass_sharded)
    from bendy_tpu_torch.parallel.multihost import free_port
    from bendy_tpu_torch.scene import load_scene

    initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl", device="cuda", timeout_s=300.0)
    try:
        scene = load_scene("scenes/cornell.json.gz")
        cam_ref = scene.find_by_tag("camera")
        scene.get_object(cam_ref).inner.aspect_ratio = width / height
        r = Renderer(scene, Config())
        cam = r.camera_params(cam_ref)
        cfg = r.trace_config(r.config, cam_ref)
        mesh = make_mesh(1, 1)
        fn = make_kernel_pass_sharded(r.arrays, mesh, width, height, spp, subsample, cfg, "full")
        base = _seed()
        sums, rays = fn(r._cam_packed, base, 0)
        xs, xr = render_pass_sharded(r.arrays, cam, base, 0, mesh, width, height, spp,
                                     subsample, cfg, "full")
        err = (sums - xs).abs() / (xs.abs() * 5e-4 + 1e-5)
        mrays = []
        before = launch_counts()
        sharded_before = make_kernel_pass_sharded.launches
        for i in range(3):
            total, ray_parts = None, []
            t0 = time.perf_counter()
            for p in range(4):  # device-chained fresh-seed passes
                s, ry = fn(r._cam_packed, base + 1 + 4 * i + p, p)
                total = s if total is None else total + s
                ray_parts.append(ry)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            mrays.append(int(torch.stack(ray_parts).sum()) / dt / 1e6)
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in COUNTED}
        launches["make_kernel_pass_sharded"] = make_kernel_pass_sharded.launches - sharded_before
        return {
            "ok": True,
            "mrays": statistics.median(mrays),
            "max_err_units": float(err.max()),
            "rays_rel_err": abs(int(rays) - int(xr)) / max(int(xr), 1),
            "kernel_ms": tracer_ms(r, cam_ref, width, height, spp, subsample),
            "launches": launches,
            "tracer": tracer_name(cfg),
            "workload": workload("cornell", width, height, spp, subsample, passes=4, repeats=3),
        }
    finally:
        dist.destroy_process_group()


def workload(scene, width, height, spp, sub, config=Config(), passes=1, repeats=7):
    """Self-describing row config (``bench.py:144-162``): every knob that
    shapes the measured work, so any row reproduces without this file.
    Blackhole rows run max_bounces=2 (every path ends on the emissive sky
    or disk); blackhole_cloud also widens volume_step to 0.6."""
    return {
        "scene": scene, "width": width, "height": height, "spp": spp,
        "subsample": sub, "max_bounces": config.max_bounces,
        "max_volume_bounces": config.max_volume_bounces,
        "volume_step": config.volume_step,
        "vol_sampling": config.vol_sampling,
        "passes_per_timing": passes, "repeats": repeats,
    }


def row(res, wl, occupancy=None) -> dict:
    """One row of the ``--full`` table, the reference's keys and the port's
    (kernel_ms, launches, tracer)."""
    out = {
        "mrays": res["median"],
        "mrays_best": res["best"],
        "seconds": res["seconds_median"],
        "kernel_ms": res["kernel_ms"],
        "launches": res["launches"],
        "tracer": res["tracer"],
        "workload": wl,
    }
    if occupancy is not None:
        out["occupancy"] = occupancy
        out["occupancy_seed"] = OCCUPANCY_SEED
    return out


# The --full rows after the headline's (bench.py:226-307): name, scene, width,
# height, spp, subsample, Config, the workload's scene label, passes and
# repeats, and whether the row records occupancy
FULL_ROWS = [
    *((name, name, 256, 256, 64, 2, Config(), name, 4, 7, True)
      for name in ("cornell2", "scene", "volume", "cloud", "dense_cloud")),
    ("blackhole_geodesic", "blackhole", 512, 512, 32, 1, Config(max_bounces=2), "blackhole",
     4, 7, True),
    ("blackhole_cloud", "blackhole_cloud", 512, 288, 32, 1,
     Config(max_bounces=2, volume_step=0.6), "blackhole_cloud", 4, 7, True),
    ("prim_grid_256_looped", "prim_grid_256", 256, 256, 16, 1, Config(max_bounces=4),
     "prim_grid_256 (generated)", 4, 7, True),
    ("cloud_field_256_looped", "cloud_field", 256, 256, 16, 1, Config(max_bounces=4),
     "cloud_field (256 volume puffs)", 4, 7, True),
    ("mass_cluster_64_looped", "mass_cluster", 256, 256, 16, 1, Config(max_bounces=2),
     "mass_cluster (64 masses)", 4, 7, True),
]
# the north star measured for real, after the sharded row (bench.py:335-341)
NORTH_STAR = ("blackhole_1080p_256spp", "blackhole", 1920, 1080, 256, 1, Config(max_bounces=2),
              "blackhole", 1, 3, False)


def load(name: str):
    """A bench scene: scenes/<name>.json.gz, or build_prim_grid(256)."""
    from bendy_tpu_torch.models.prim_grid import build_prim_grid
    from bendy_tpu_torch.scene import load_scene

    return build_prim_grid(256) if name == "prim_grid_256" else load_scene(
        f"scenes/{name}.json.gz")


def full_row(spec) -> dict:
    name, scene, w, h, spp, sub, cfg, label, passes, repeats, occ = spec
    res = timed_render(load(scene), w, h, spp, sub, cfg, repeats=repeats, passes=passes)
    out = row(res, workload(label, w, h, spp, sub, cfg, passes=passes, repeats=repeats),
              occupancy(load(scene), w, h, spp, sub, cfg) if occ else None)
    print(f"{name}: {res['median']:.1f} Mrays/s median ({res['seconds_median']:.4f} s a pass, "
          f"tracer alone {res['kernel_ms']:.3f} ms) occ={out.get('occupancy')}", file=sys.stderr)
    return out


def headline(scene) -> tuple[dict, dict]:
    """(timed_render's result, the headline line) of cornell 256x256@64spp
    x4, 4 chained passes, with the reference's degraded-window retry: a
    median below 0.75 x the best repeats the measurement once and keeps the
    run with the better median, both medians reported."""
    res = timed_render(scene, 256, 256, 64, 2, passes=4)
    retry_median = None
    if res["median"] < 0.75 * res["best"]:
        print("degraded-window spread detected; repeating measurement", file=sys.stderr)
        res2 = timed_render(scene, 256, 256, 64, 2, passes=4)
        retry_median = min(res["median"], res2["median"])
        if res2["median"] > res["median"]:
            res = res2
    line = {
        "metric": "Mrays/sec/chip cornell 256x256@64spp(x4 subpixels), median of 7 (4-pass chained)",
        "value": res["median"],
        "unit": "Mrays/s",
        "vs_baseline": res["median"] / TARGET,
        "best": res["best"],
        "seconds": res["seconds_median"],
        "kernel_ms": res["kernel_ms"],
        "workload": workload("cornell", 256, 256, 64, 2, passes=4),
    }
    if retry_median is not None:
        line["retried"] = True
        line["discarded_median"] = retry_median
    return res, line


def main(argv=None) -> int:
    from bendy_tpu_torch.scene import load_scene
    from bendy_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="every row, written to --out")
    ap.add_argument("--out", default="benches_results_torch.json")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")  # raises without a card
    t0 = time.time()
    meta = provenance(dev)
    res, line = headline(load_scene("scenes/cornell.json.gz"))
    line["device"] = meta.get("card")
    print(json.dumps(line), flush=True)
    if not args.full:
        return 0
    results = {"cornell": row(res, workload("cornell", 256, 256, 64, 2, passes=4),
                              occupancy(load_scene("scenes/cornell.json.gz")))}
    for spec in FULL_ROWS:
        results[spec[0]] = full_row(spec)
    results["kernel_sharded_1x1"] = sharded_row()
    print(f"kernel_sharded_1x1: {results['kernel_sharded_1x1']}", file=sys.stderr)
    results[NORTH_STAR[0]] = full_row(NORTH_STAR)
    results["_meta"] = {**meta, "seconds": time.time() - t0}
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
