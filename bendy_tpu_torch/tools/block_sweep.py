"""Sweep the tracer's threads per block and the lane order on the card.

Counterpart of the reference's ``tools/block_sweep.py``, which chose its
block rows per scene class under tile-major lanes. Here the block is a
build parameter of the tracer (``_build.library(block=n)``, each variant
built at first use) and the lane order is the render pass's ``tile``
(``ops/trace_kernel.tile_perm``). For each scene, threads per block and
order it times the render pass by the bench's protocol (``bench.py``'s
``timed_render``: fresh seeds, 4 chained passes per timed region, the
median and best over the regions, the rays read after each region) and the
tracer alone on the pass's lanes (the median, min and max of 7 calls with
fresh seeds, ``tools.cuda_ms_median``), and prints the rays per warp issue
slot and the block tail (the slowest block's loop length over the mean
block's) of one call at the bench's occupancy seed, and the ptxas
registers and spills of the instantiation the scene runs in that variant.

    python3 -m bendy_tpu_torch.tools.block_sweep [scene ...] [--threads 64 128 256]
        [--spp 64] [--res 256] [--subsample 2] [--max-bounces N] [--repeats 4]
        [--no-tile] [--out FILE]

Every scene renders at res² pixels, ``subsample``² subpixels and ``spp``
samples in the reference's configuration (``tools/perf_report.
SCENE_CONFIG_KW``), its bounce cap replaced by ``--max-bounces`` when given
(the main paths' shapes: 16 spp, 1×1 and 4 bounces for prim_grid_256 and
cloud_field, 3 for light_field_200). Both lane orders run unless
``--no-tile`` (row-major only). ``--out`` writes the rows with the card's
name and power limit. It raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

PASSES = 4  # chained passes per timed region
KERNEL_REPEATS = 7


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scenes", nargs="*", default=["cornell", "cloud", "blackhole"])
    ap.add_argument("--threads", type=int, nargs="*", default=[64, 128, 256])
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--subsample", type=int, default=2)
    ap.add_argument("--max-bounces", type=int, default=None)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--no-tile", action="store_true", help="row-major lanes only")
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    return ap.parse_args(argv)


def instantiation(cfg, table_floats: int, counts: dict) -> str:
    """The ptxas label (``_build.trace_label``) of the tracer instantiation
    a FULL-output launch of ``cfg`` with a table of ``tracer_table`` (its
    size and counts) runs."""
    from bendy_tpu_torch import _build
    from bendy_tpu_torch.ops.trace_kernel import stays_in_global

    loopm = cfg.geodesic and cfg.looped_masses
    gtab = stays_in_global(_build.library(), cfg, table_floats, counts)
    return _build.trace_label(0, int(cfg.geodesic), int(cfg.has_volumes), int(loopm), int(gtab),
                              int("bvh0" in counts))


def sweep_one(name: str, threads: int, tile: bool, res: int, spp: int, repeats: int,
              device, subsample: int = 2, max_bounces: int | None = None) -> dict:
    """One (scene, threads per block, lane order) row, in the variant of
    ``threads`` (``_build.trace_block``)."""
    from dataclasses import replace

    import torch

    from bendy_tpu_torch import _build
    from bendy_tpu_torch.bench import OCCUPANCY_SEED
    from bendy_tpu_torch.ops.trace_kernel import make_render_pass, make_tracer, tracer_table
    from bendy_tpu_torch.tools import cuda_ms_median, rays_per_warp_issue_slot
    from bendy_tpu_torch.tools.perf_report import scene_config, scene_renderer, thread_counts

    W = H = res
    with _build.trace_block(threads):
        _, build_s = _build.build()
        config = scene_config(name)
        if max_bounces is not None:
            config = replace(config, max_bounces=max_bounces)
        r, cam_ref = scene_renderer(name, config, W, H, device)
        cfg = r.trace_config(r.config, cam_ref)
        fn = make_render_pass(r.arrays, W, H, H, spp, subsample, cfg, "full", tile=tile)
        base = int.from_bytes(os.urandom(4), "little") & 0x3FFFFFFF
        film = torch.zeros((H, W, 3), dtype=torch.float32, device=r.device)
        rays = torch.zeros(1, dtype=torch.int64, device=r.device)
        fn(r._cam_packed, base, 0, 0, film, add=True, rays=rays)  # warm-up
        torch.cuda.synchronize()
        rates, secs = [], []
        for i in range(repeats):
            rays.zero_()
            t0 = time.perf_counter()
            for p in range(PASSES):
                fn(r._cam_packed, base + 1 + i * PASSES + p, p, 0, film, add=True, rays=rays)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rates.append(int(rays) / dt / 1e6)  # the rays fetch: untimed
            secs.append(dt / PASSES)
        pix, sub = fn.lanes(0, r.device)
        tracer = make_tracer(r.arrays, W, H, spp, subsample, cfg)
        _, ms, lo, hi = cuda_ms_median(
            lambda i: tracer.words(r._cam_packed, base + 100 + i, 0, pix, sub), KERNEL_REPEATS)
        res_occ = tracer(r._cam_packed, OCCUPANCY_SEED, 0, pix, sub, count_items=True)
        t_rays, t_iters = thread_counts(res_occ, pix.numel(), spp, cfg)
        n = t_iters.numel() // threads * threads
        blocks = t_iters[:n].view(-1, threads).max(dim=1).values.double()
        table, counts = tracer_table(r.arrays.host_copy(), cfg)
        label = instantiation(cfg, table.size, counts)
        ptxas = [ln for ln in _build.ptxas_report(_build.build_log()) if ln.startswith(label + ":")]
    return {
        "scene": name, "threads": threads, "tile": tile, "width": W, "height": H, "spp": spp,
        "subsample": subsample, "max_bounces": cfg.max_bounces,
        "mrays_median": statistics.median(rates), "mrays_best": max(rates),
        "seconds_median": statistics.median(secs), "repeats": repeats,
        "tracer_ms": ms, "tracer_ms_min": lo, "tracer_ms_max": hi,
        "rays_per_warp_issue_slot": rays_per_warp_issue_slot(t_rays, t_iters),
        "block_tail": float(blocks.max() / blocks.mean()),
        "ptxas": ptxas[0] if ptxas else None, "build_s": build_s,
    }


def main(argv=None) -> int:
    from bendy_tpu_torch.tools import provenance
    from bendy_tpu_torch.utils.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device("cuda")  # raises without a card
    t0 = time.time()
    rows = []
    for name in args.scenes:
        for threads in args.threads:
            for tile in ((False,) if args.no_tile else (True, False)):
                row = sweep_one(name, threads, tile, args.res, args.spp, args.repeats, dev,
                                args.subsample, args.max_bounces)
                rows.append(row)
                print(f"{name} threads={threads} tile={tile}: median {row['mrays_median']:.1f} "
                      f"best {row['mrays_best']:.1f} Mrays/s; tracer alone "
                      f"{row['tracer_ms']:.3f} ms ({row['tracer_ms_min']:.3f}-"
                      f"{row['tracer_ms_max']:.3f}); rays per warp issue slot "
                      f"{row['rays_per_warp_issue_slot']:.4f}, block tail "
                      f"{row['block_tail']:.3f}; {row['ptxas']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "_meta": {**provenance(dev), "seconds": time.time() - t0,
                                               "argv": sys.argv[1:] if argv is None else argv}},
                      f, indent=2)
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
