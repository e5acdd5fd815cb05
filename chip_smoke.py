#!/usr/bin/env python3
"""Drive the bendy_tpu_torch main path once on one CUDA card and check it.

    python3 chip_smoke.py      # from the repo root; builds the kernels itself

Phases, one line each (any failure exits non-zero):
  1. the card: needs torch.cuda.is_available(); prints nvidia-smi's name and
     power limit,
  2. builds the CUDA kernels from bendy_tpu_torch/csrc with nvcc,
  3. kernel vs plain on the card: the tracer kernel against the plain
     PyTorch integrator on cornell, cornell2 and scene at 16x16, 4 spp,
     max_bounces=3, seed 7, in FULL and NORMAL output (per lane rtol 5e-4,
     atol 1e-5, equal int64 ray counts), then the Renderer against the
     cornell CPU golden at the same tolerance,
  4. the main path: Renderer(cornell) at 256x256, 64 spp, 2x2 subpixels,
     default Config, into a DeviceFilm — one warm-up pass, then 4 chained
     timed passes (Mrays/s, seconds per pass, the kernel's launch count);
     then the kernel alone, one kernel pass (lanes, launch, subpixel sum)
     and one plain pass at the same geometry and seed, each timed with CUDA
     events; the two passes are compared per pixel and by ray count.
It prints the kernel table as one JSON line, then the result line
{"ok": true, "device": {...}} last.
"""

import json
import os
import subprocess
import sys
import time

SCENES = ("cornell", "cornell2", "scene")
RTOL, ATOL = 5e-4, 1e-5


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def lane_mismatch(a, b) -> int:
    """Lanes where |a-b| > atol + rtol·|b| (b is the plain version)."""
    return int(((a - b).abs() > ATOL + RTOL * b.abs()).sum())


def cuda_ms(fn, repeats: int = 1, warmup: int = 0):
    """(last result, mean ms per call) timed with CUDA events, after
    ``warmup`` untimed calls (first-call set-up such as table uploads)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / repeats


def kernel_vs_plain(dev) -> float:
    import numpy as np
    import torch

    from bendy_tpu_torch import Config, Film, Output, RenderConfig, Renderer, Subsample, load_scene
    from bendy_tpu_torch.ops.trace_kernel import make_tracer
    from bendy_tpu_torch.ops.wavefront import trace_core
    from bendy_tpu_torch.utils.rng import render_key

    W = H = 16
    spp = 4
    pix = torch.arange(W * H, dtype=torch.int32, device=dev)
    sub = torch.zeros(W * H, dtype=torch.int32, device=dev)
    worst = 0.0
    for name in SCENES:
        for output in (Output.FULL, Output.NORMAL):
            scene = load_scene(f"scenes/{name}.json.gz")
            cam = scene.find_by_tag("camera")
            scene.get_object(cam).inner.aspect_ratio = 1.0
            r = Renderer(scene, Config(max_bounces=3, output=output), device=dev)
            cfg = r.trace_config(r.config, cam)
            params = r.camera_params(cam)
            kern = make_tracer(r.arrays, W, H, spp, 1, cfg)(r._cam_packed, 7, 0, pix, sub)
            plain = trace_core(r.arrays, params, render_key(7, 0), pix, sub, W, H, spp, 1, cfg)
            torch.cuda.synchronize()
            fields = [("radiance", "xyz")]
            if cfg.want_aovs:
                fields += [("aov_albedo", "xyz"), ("aov_normal", "xyz")]
            pairs = [(getattr(getattr(kern, f), c), getattr(getattr(plain, f), c))
                     for f, cs in fields for c in cs]
            if cfg.want_aovs:
                pairs.append((kern.aov_depth, plain.aov_depth))
            bad = sum(lane_mismatch(a, b) for a, b in pairs)
            err = max(float((a - b).abs().max()) for a, b in pairs)
            worst = max(worst, err)
            rays_k, rays_p = int(kern.rays), int(plain.rays)
            iters_k, iters_p = int(kern.iters), int(plain.iters)
            print(f"phase 3: {name} {output.value}: lanes off {bad}, max |diff| {err:.3e}, "
                  f"rays kernel {rays_k} plain {rays_p}, lane iterations kernel {iters_k} "
                  f"plain {iters_p}")
            if bad or rays_k != rays_p or iters_k != iters_p or kern.rays.dtype != torch.int64:
                fail(f"kernel disagrees with plain on {name} {output.value}")
    scene = load_scene("scenes/cornell.json.gz")
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = 1.0
    film = Film(16, 16)
    Renderer(scene, Config(max_bounces=3), device=dev).render(
        cam, RenderConfig(samples=8, subsample=Subsample(1)), film, seed=7)
    golden = np.load("tests/golden/cornell_16x16_mb3_s8_seed7.npy")
    err = float(np.abs(film.mean() - golden).max())
    off = int((np.abs(film.mean() - golden) > ATOL + RTOL * np.abs(golden)).sum())
    print(f"phase 3: cornell golden through the Renderer: values off {off}, max |diff| {err:.3e}")
    if off:
        fail("Renderer on the card misses the cornell golden")
    return max(worst, err)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}")

    from bendy_tpu_torch import _build

    lib_path, build_s = _build.build()
    regs = [ln.split("info    :")[-1].strip() for ln in _build.build_log().splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"phase 2: built {lib_path.name} in {build_s:.1f} s; ptxas: {' | '.join(regs)}")

    phase3_err = kernel_vs_plain(dev)

    import numpy as np

    from bendy_tpu_torch import DeviceFilm, RenderConfig, Renderer, Subsample, load_scene
    from bendy_tpu_torch.ops.trace_kernel import (
        make_render_pass,
        pass_lanes,
        scene_table,
        trace_surface,
    )
    from bendy_tpu_torch.render import render_pass
    from bendy_tpu_torch.utils.rng import render_key

    W = H = 256
    spp, n = 64, 2
    scene = load_scene("scenes/cornell.json.gz")
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = W / H
    r = Renderer(scene, device=dev)
    rc = RenderConfig(samples=spp, subsample=Subsample(n))
    seed = int.from_bytes(os.urandom(4), "little")
    film = DeviceFilm(W, H, device=dev)
    r.render(cam, rc, film, seed=seed)  # warm-up (and first-use build)
    film.synchronize()
    rays0 = r.rays_traced
    trace_surface.launches = 0
    t0 = time.perf_counter()
    for _ in range(4):
        r.render(cam, rc, film, seed=seed)
    film.synchronize()
    dt = time.perf_counter() - t0
    launches = trace_surface.launches
    rays = r.rays_traced - rays0
    mean = film.mean()
    print(f"phase 4: main path cornell {W}x{H} {spp} spp 2x2: 4 passes in {dt:.4f} s, "
          f"{dt / 4:.4f} s/pass, {rays} rays, {rays / dt / 1e6:.1f} Mrays/s, "
          f"kernel launches {launches}")
    if launches != 4:
        fail(f"main path launched the tracer kernel {launches} times, expected 4")
    if not (np.isfinite(mean).all() and mean.shape == (H, W, 3) and mean.mean() > 0):
        fail("main-path film is not finite and non-zero")

    cfg = r.trace_config(r.config, cam)
    nn = n * n
    table_np, counts = scene_table(r.arrays.host_copy())
    table = torch.from_numpy(table_np).to(dev)
    pix, sub = pass_lanes(W, H, nn, 0, dev)
    _, kernel_ms = cuda_ms(lambda: trace_surface(
        table, counts, r._cam_packed.reshape(-1), pix, sub, width=W, height=H, spp=spp,
        spp_total=spp, subsample=n, key=render_key(seed, 0), sample0=0, cfg=cfg), 10, 1)
    kern_pass = make_render_pass(r.arrays, W, H, H, spp, n, cfg, "full")
    (k_sums, k_rays), pass_ms = cuda_ms(lambda: kern_pass(r._cam_packed, seed, 0, 0), 10, 1)
    (p_sums, p_rays), plain_ms = cuda_ms(
        lambda: render_pass(r.arrays, r.camera_params(cam), seed, 0, 0, W, H, H, spp, n,
                            cfg, "full"))
    close = ((k_sums - p_sums).abs() <= ATOL + RTOL * p_sums.abs()).all(dim=-1)
    share = float(close.float().mean())
    mean_rel = abs(float(k_sums.mean()) - float(p_sums.mean())) / abs(float(p_sums.mean()))
    max_err = float((k_sums - p_sums).abs().max())
    print(f"phase 4: kernel vs plain pass at {W}x{H}: pixels within tol {share:.6f}, "
          f"image mean rel diff {mean_rel:.3e}, max |diff| {max_err:.3e}, rays kernel "
          f"{int(k_rays)} plain {int(p_rays)}; kernel alone {kernel_ms:.3f} ms, kernel pass "
          f"(lanes, launch, subpixel sum) {pass_ms:.3f} ms, plain pass {plain_ms:.1f} ms")
    if share < 0.999 or mean_rel > 1e-4:
        fail("kernel pass disagrees with the plain pass at the main-path shape")
    if int(k_rays) != int(p_rays):
        fail("kernel pass and plain pass count different rays at the main-path shape")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "trace_surface",
        "route": "cuda",
        "source": "bendy_tpu_torch/csrc/trace_surface.cu",
        "replaces": "bendy_tpu/ops/pallas_trace.py:255",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "pass_ms": pass_ms,
        "max_abs_err_16x16": phase3_err,
        "mrays_per_s": rays / dt / 1e6,
        "s_per_pass": dt / 4,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
