"""Command-line renderer, mirroring the reference binary's interface.

Counterpart of ``bendy_tpu/cli.py``: the same flags, defaults and exit
codes, headless (progressive passes with per-sample telemetry on stderr,
the tonemapped PNG written to ``--screenshot``), on the card by default.

    python3 -m bendy_tpu_torch.cli --scene scenes/cornell.json.gz \\
        --width 256 --height 256 --samples 64 --subsample 2 --spp-per-pass 16
    python3 -m bendy_tpu_torch.cli ... --device cpu        # the plain integrator
    python3 -m bendy_tpu_torch.cli ... --mesh 2x2          # 4 local ranks
    torchrun --nproc-per-node 4 -m bendy_tpu_torch.cli ... --mesh 2x2

Additions over the reference app, as in ``bendy_tpu`` (marked [+] there):
the ``depth`` channel, ``--checkpoint`` (exact resume, in the reference's
``.npz`` layout, so either package resumes the other's), ``--save-scene``,
``--seed``, ``--preview-every``, ``--turntable``, ``--serve`` with the
live preview and its control endpoints, ``--mesh``.

Differences from ``bendy_tpu.cli``:
- ``--device {cuda,cpu}`` (default cuda): where the render runs; without a
  card the default raises, nothing falls back to the CPU;
- ``--profile DIR`` writes a ``torch.profiler`` trace (chrome JSON);
- ``--debug-nans`` raises ``FloatingPointError`` naming the first pass whose
  sums hold a NaN (one sync per pass, only under the flag);
- no ``--compile-cache``: the kernels build once per checkout into
  ``bendy_tpu_torch/_build/<hash>/`` and every later process loads them,
  so there is no per-process compile to cache.

``--mesh TxS`` renders one pass split over a (tiles, samples) mesh of
ranks (``parallel/mesh.py``): under ``torchrun`` (``WORLD_SIZE`` set) it
joins that world; otherwise it spawns T·S local ranks on a free localhost
port. The backend rule is ``parallel.multihost.choose_backend``: nccl, a
card per rank, on the card; gloo on the CPU. As in the reference
(``bendy_tpu/cli.py:384-386``) the mesh render takes only ``--output``
from the render flags (the default ``Config`` otherwise), so both CLIs
render the same image. Rank 0 writes the PNG and the telemetry line.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np
import torch

from bendy_tpu_torch.film import DeviceFilm, Film
from bendy_tpu_torch.render import Config, Output, Renderer, RenderConfig, Subsample
from bendy_tpu_torch.scene.graph import Scene, Update, UpdateQueue, affine_look_at
from bendy_tpu_torch.scene.io import load_scene, save_scene
from bendy_tpu_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bendy-tpu-torch", description=__doc__.split("\n")[0])
    # reference flags + defaults (``src/main.rs:49-72``)
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--output", choices=["full", "albedo", "normal", "depth"], default="full")
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--subsample", type=int, default=2)
    p.add_argument("--screenshot", default="screenshots/render.png")
    p.add_argument("--scene", default="scene.json")
    # extensions, as bendy_tpu.cli
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None, help="film checkpoint (.npz) to resume/save")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="also checkpoint every N passes (default: only at exit and on "
                        "POST /checkpoint; each save fetches the whole film from the card)")
    p.add_argument("--save-scene", default=None, help="write the loaded scene back out")
    p.add_argument("--preview-every", type=int, default=0, help="write PNG every N samples")
    p.add_argument("--spp-per-pass", type=int, default=1,
                   help="samples per progressive pass (1 = reference cadence)")
    p.add_argument("--serve", type=int, default=0,
                   help="serve a live preview + control API on this port")
    p.add_argument("--serve-host", default="127.0.0.1",
                   help="preview bind address (control endpoints mutate the render — "
                        "exposing beyond loopback is opt-in)")
    p.add_argument("--max-bounces", type=int, default=None)
    p.add_argument("--volume-step", type=float, default=None)
    p.add_argument("--vol-sampling", choices=["trilinear", "nearest"], default="trilinear",
                   help="density lookup mode (SamplingMode, volume.rs:12-18)")
    p.add_argument("--geo-eta", type=float, default=None,
                   help="geodesic step fraction of distance-to-mass")
    p.add_argument("--geo-max-steps", type=int, default=None, help="RK4 step budget per path")
    p.add_argument("--geo-far", type=float, default=None,
                   help="flat-space switchover radius in units of rs")
    p.add_argument("--turntable", type=int, default=0, metavar="N",
                   help="render N frames orbiting the camera around the scene origin "
                        "(the camera is a launch argument: no frame rebuilds anything); "
                        "writes <screenshot>_###.png")
    p.add_argument("--mesh", default=None, metavar="TILESxSAMPLES",
                   help="render one pass across a mesh of ranks, e.g. 2x2 "
                        "(torch.distributed; local ranks are spawned unless run "
                        "under torchrun)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the render into DIR")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError at the first pass whose sums hold a NaN")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="render on the card (default) or with the plain integrator on "
                        "the CPU")
    return p


def default_scene() -> Scene:
    """The built-in Cornell box (``src/main.rs:108-214``)."""
    from bendy_tpu_torch.models.cornell import build_cornell

    return build_cornell()


def load_cli_scene(args, quiet: bool = False) -> Scene:
    """``--scene`` if it exists, else the built-in cornell box."""
    if os.path.exists(args.scene):
        scene = load_scene(args.scene)
        msg = f"loaded scene from {args.scene}"
    else:
        scene = default_scene()
        msg = "scene file missing; using built-in cornell box"
    if not quiet:
        print(msg, file=sys.stderr)
    return scene


def set_aspect(scene: Scene, camera: int, width: int, height: int) -> None:
    """Aspect-ratio sync through the update queue, like the app
    (``src/main.rs:216-223``)."""
    queue = UpdateQueue()
    aspect = width / height

    def apply(obj, _q, _d):
        obj.as_camera().aspect_ratio = aspect

    queue.push(Update.object(camera, apply))
    queue.commit(scene)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # the card, or raise: no fallback

    scene = load_cli_scene(args)
    if args.save_scene:
        save_scene(args.save_scene, scene)
        print(f"saved scene to {args.save_scene}", file=sys.stderr)

    camera = scene.find_by_tag("camera")
    if camera is None:
        print("error: scene has no object tagged 'camera'", file=sys.stderr)
        return 2
    set_aspect(scene, camera, args.width, args.height)

    output = Output(args.output)
    subsample = Subsample(0 if args.subsample in (0, 1) else args.subsample)
    if args.mesh:
        return render_sharded_oneshot(args)

    geo = None
    if any(v is not None for v in (args.geo_eta, args.geo_max_steps, args.geo_far)):
        from bendy_tpu_torch.geodesic import geo_from_dict

        # flags overlay the scene file's "geodesic" block (which overlays
        # the GeoParams defaults); untouched fields keep the scene's values
        defaults = geo_from_dict(getattr(scene, "geodesic", None))
        geo = defaults._replace(**{k: v for k, v in [
            ("eta", args.geo_eta), ("max_steps", args.geo_max_steps), ("far", args.geo_far),
        ] if v is not None})
    renderer = Renderer(scene, Config(output=output, vol_sampling=args.vol_sampling, geo=geo),
                        device=device)

    # the film lives on the render device: passes chain with no host
    # traffic; PNGs, checkpoints and the preview fetch on their own cadence
    if args.checkpoint and os.path.exists(args.checkpoint):
        film, _ = Film.load_checkpoint(args.checkpoint)
        if (film.width, film.height) != (args.width, args.height):
            print("checkpoint resolution mismatch; starting fresh", file=sys.stderr)
            film = DeviceFilm(args.width, args.height, output.color_space(), device)
        else:
            print(f"resumed checkpoint at {film.samples} samples ({film.passes} passes)",
                  file=sys.stderr)
            film = DeviceFilm.from_film(film, device)
    else:
        film = DeviceFilm(args.width, args.height, output.color_space(), device)

    max_samples = args.samples * max(subsample.n, 1) ** 2
    rc = RenderConfig(samples=args.spp_per_pass, subsample=subsample,
                      max_bounces=args.max_bounces, volume_step=args.volume_step)

    if args.turntable:
        return render_turntable(args, scene, renderer, camera, film, rc, max_samples)

    server = None
    if args.serve:
        from bendy_tpu_torch.preview import PreviewServer

        server = PreviewServer(args.serve, host=args.serve_host)
        print(f"live preview at http://{args.serve_host}:{args.serve}/", file=sys.stderr)

    profiler = None
    if args.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()

    start = time.time()
    sum_delta = 0.0
    stopped = False
    while film.samples < max_samples and not stopped:
        t0 = time.time()
        renderer.render(camera, rc, film, seed=args.seed)
        if args.debug_nans and bool(torch.isnan(film.sum).any()):
            raise FloatingPointError(f"NaN in the film after pass {film.passes - 1} "
                                     f"(samples {film.samples})")
        delta = time.time() - t0
        sum_delta += delta
        # telemetry cadence mirrors the title bar (``src/main.rs:352-388``)
        print(f"samples: {film.samples}/{max_samples}; delta t: {delta*1000:.0f}ms; "
              f"avg t per sample: {sum_delta/max(film.samples,1)*1000:.1f}ms", file=sys.stderr)
        if server is not None:
            # rays_traced fetches the pending counters (a sync): lazy, so it
            # runs only when a /stats client is polling
            server.publish(film, lazy=lambda: {"mrays": round(
                renderer.rays_traced / max(sum_delta, 1e-9) / 1e6, 1)})
            for name, cargs in server.drain_commands():
                # a bad command must not take down a long render
                try:
                    scene, renderer, camera, stop_now = handle_command(
                        name, cargs, args, scene, renderer, camera, film)
                    stopped = stopped or stop_now
                except Exception as e:
                    print(f"command {name!r} failed: {e}", file=sys.stderr)
        if args.preview_every and film.passes % args.preview_every == 0:
            _write_png(args.screenshot, film)
        if args.checkpoint and args.checkpoint_every and film.passes % args.checkpoint_every == 0:
            film.save_checkpoint(args.checkpoint, seed=args.seed)

    if args.checkpoint:  # final state always persists (exact resume)
        film.save_checkpoint(args.checkpoint, seed=args.seed)

    if profiler is not None:
        profiler.stop()
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "trace.json")
        profiler.export_chrome_trace(path)
        print(f"profiler trace written to {path}", file=sys.stderr)

    total = time.time() - start
    print(f"total t: {total:.2f}s; rays traced: {renderer.rays_traced}; "
          f"{renderer.rays_traced/max(total,1e-9)/1e6:.1f} Mrays/s", file=sys.stderr)
    _write_png(args.screenshot, film)
    if server is not None:
        server.close()
    return 0


def handle_command(name, cargs, args, scene, renderer, camera, film):
    """Apply one runtime control command (the reference's live-loop hotkeys,
    ``src/main.rs:275-348``, received over HTTP between passes).

    Returns the possibly-replaced (scene, renderer, camera, stopped).
    """
    stopped = False
    if name == "screenshot":  # Ctrl+P (main.rs:275-298)
        _write_png(args.screenshot, film)
    elif name == "save-scene":  # Ctrl+K (main.rs:299-313)
        # a remote-triggered default must not overwrite the input scene
        path = cargs.get("path") or args.save_scene or args.scene + ".saved.json.gz"
        save_scene(path, scene)
        print(f"saved scene to {path}", file=sys.stderr)
    elif name == "reload-scene":  # Ctrl+L: reload + clear film (main.rs:314-335)
        if not os.path.exists(args.scene):
            print(f"reload failed: {args.scene} missing", file=sys.stderr)
            return scene, renderer, camera, stopped
        scene = load_scene(args.scene)
        camera = scene.find_by_tag("camera")
        scene.get_object(camera).as_camera().aspect_ratio = film.width / film.height
        renderer = Renderer(scene, renderer.config, device=renderer.device)
        film.clear()
        print(f"reloaded scene from {args.scene}; film cleared", file=sys.stderr)
    elif name == "resize":  # window resize (main.rs:337-348)
        w = int(cargs.get("width", film.width))
        h = int(cargs.get("height", film.height))
        film.resize(w, h)
        scene.get_object(camera).as_camera().aspect_ratio = w / h
        print(f"resized film to {w}x{h}; film cleared", file=sys.stderr)
    elif name == "checkpoint":
        path = cargs.get("path") or args.checkpoint or "film_checkpoint.npz"
        film.save_checkpoint(path, seed=args.seed)
        print(f"checkpoint written to {path}", file=sys.stderr)
    elif name == "camera":  # move/aim the live camera; film restarts
        obj = scene.get_object(camera)
        world = obj.transform.world
        eye = [float(cargs.get(k, world[i, 3])) for i, k in enumerate("xyz")]
        if any(k in cargs for k in ("tx", "ty", "tz")):
            target = [float(cargs.get("t" + k, 0.0)) for k in "xyz"]
            obj.transform.set_world(affine_look_at(eye, target))
        else:
            world = world.copy()
            world[:, 3] = eye
            obj.transform.set_world(world)
        film.clear()
        # the camera is a launch argument: the next pass re-packs it
        print(f"camera moved to {eye}; film cleared", file=sys.stderr)
    elif name == "stop":
        stopped = True
        print("stop requested; finishing up", file=sys.stderr)
    return scene, renderer, camera, stopped


def render_turntable(args, scene, renderer, camera, film, rc, max_samples) -> int:
    """N-frame orbit around the scene origin at the camera's initial height
    and distance, aimed at the origin; frames go to <screenshot>_###.png."""
    obj = scene.get_object(camera)
    eye0 = np.asarray(obj.transform.world[:, 3], np.float64)
    radius = math.hypot(eye0[0], eye0[2])
    if radius < 1e-9:
        print("error: camera sits on the orbit axis (y); move it first", file=sys.stderr)
        return 2
    phase = math.atan2(eye0[0], eye0[2])
    base, ext = os.path.splitext(args.screenshot)
    start = time.time()
    for i in range(args.turntable):
        a = phase + 2.0 * math.pi * i / args.turntable
        eye = (radius * math.sin(a), eye0[1], radius * math.cos(a))
        obj.transform.set_world(affine_look_at(eye, (0.0, 0.0, 0.0)))
        film.clear()
        t0 = time.time()
        while film.samples < max_samples:
            renderer.render(camera, rc, film, seed=args.seed + i)
        _write_png(f"{base}_{i:03d}{ext}", film)
        print(f"frame {i + 1}/{args.turntable}: {time.time() - t0:.2f}s", file=sys.stderr)
    total = time.time() - start
    print(f"turntable: {args.turntable} frames in {total:.2f}s "
          f"({total / args.turntable:.2f}s/frame)", file=sys.stderr)
    return 0


def parse_mesh(spec: str) -> tuple[int, int]:
    tiles, samples = (int(v) for v in spec.lower().split("x"))
    return tiles, samples


def render_sharded_oneshot(args) -> int:
    """One pass over a (tiles, samples) mesh: in this process's world under
    torchrun, else on spawned local ranks."""
    from bendy_tpu_torch.parallel.mesh import spawn

    tiles, samples = parse_mesh(args.mesh)
    if "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        from bendy_tpu_torch.parallel import initialize, make_mesh

        initialize(device=args.device)
        try:
            mesh_rank(make_mesh(tiles, samples, args.device), args)
        finally:
            dist.destroy_process_group()
        return 0
    spawn(mesh_rank, tiles, samples, device=args.device, args=(args,))
    return 0


def mesh_rank(mesh, args) -> None:
    """This rank's share of the ``--mesh`` render: the reference's one-shot
    (``bendy_tpu/cli.py:376-401``), ``Config(output=...)`` and the trace
    config without the camera, as it builds them. Rank 0 gathers the rows,
    prints the telemetry line and writes the PNG."""
    from bendy_tpu_torch.parallel import film_to_host0, render_film_sharded

    scene = load_cli_scene(args, quiet=mesh.rank != 0)
    camera = scene.find_by_tag("camera")
    set_aspect(scene, camera, args.width, args.height)
    output = Output(args.output)
    subsample = Subsample(0 if args.subsample in (0, 1) else args.subsample)
    renderer = Renderer(scene, Config(output=output), device=mesh.device)
    renderer.camera_params(camera)
    cfg = renderer.trace_config(renderer.config)
    spp_local = max(1, args.samples // mesh.samples)
    t0 = time.time()
    sums, spp, rays = render_film_sharded(
        renderer.arrays, renderer._cam_packed, mesh, args.width, args.height, spp_local,
        subsample.n, cfg, output.value, seed=args.seed)
    sums = film_to_host0(sums, mesh)
    if mesh.rank != 0:
        return
    film = Film(args.width, args.height, output.color_space())
    film.add_pass(sums, spp)
    dt = time.time() - t0
    print(f"mesh {mesh.tiles}x{mesh.samples}: {film.samples} spp in {dt:.2f}s; "
          f"{rays/dt/1e6:.1f} Mrays/s", file=sys.stderr)
    _write_png(args.screenshot, film)


def _write_png(path: str, film: Film) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    film.save_png(path)
    print(f"saved screenshot to {path}", file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
