"""Sharded rendering over a (tiles, samples) mesh of ranks.

Counterpart of ``bendy_tpu/parallel/mesh.py`` on ``torch.distributed``:

    mesh axes (tiles, samples), rank r = ti·samples + si
    - tiles:   image rows split across ranks, no communication while
               tracing (rays are independent),
    - samples: the samples of each pixel split across ranks; the partial
               films of a tile's sample ranks are summed by one all-reduce
               at the end of the pass.

RNG streams are keyed by global lane ids (pixel, global sample), so any
mesh computes the same per-lane radiance as one device; only the f32
summation order of the film differs. Scene tables and the camera are small
and every rank holds them.

:func:`make_kernel_pass_sharded` is the counterpart of
``make_pallas_pass_sharded`` (mesh.py:146): each rank launches the CUDA
tracer (``ops/trace_kernel.py``) on its lanes, which is the plain
integrator on a CPU mesh. :func:`render_pass_sharded` is its plain
version on any device, the one the kernel is timed against. Each rank
feeds its lanes row-major or, with ``tile``, in the reference's tile-major
order, which changes no pixel. :func:`spawn` runs a function on
tiles·samples local ranks, each in its own process.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from bendy_tpu_torch.ops.camera import CameraParams
from bendy_tpu_torch.ops.trace_kernel import (TILE, accumulate, make_tracer, pass_lanes,
                                              pixel_sums, render_lanes)
from bendy_tpu_torch.ops.wavefront import TraceConfig, trace_core
from bendy_tpu_torch.parallel.multihost import (
    DEFAULT_TIMEOUT_S,
    film_to_host0,
    free_port,
    initialize,
    rank_device,
)
from bendy_tpu_torch.scene.compiler import SceneArrays
from bendy_tpu_torch.utils.rng import render_key


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (tiles, samples) mesh over the initialized
    world, with its tile's sample group and a gloo group for host traffic."""

    tiles: int
    samples: int
    rank: int
    device: torch.device
    sample_group: Any
    host_group: Any

    @property
    def world(self) -> int:
        return self.tiles * self.samples

    @property
    def ti(self) -> int:
        return self.rank // self.samples

    @property
    def si(self) -> int:
        return self.rank % self.samples


def make_mesh(tiles: int, samples: int = 1, device: str = "cuda") -> Mesh:
    """A (tiles, samples) mesh over the initialized world, whose size must be
    exactly tiles·samples; rank r is (ti, si) = divmod(r, samples), the
    order of ``np.asarray(devices).reshape(tiles, samples)`` in the
    reference. Every rank must call it (it creates the groups)."""
    if tiles < 1 or samples < 1:
        raise ValueError(f"mesh axes must be >= 1, got {tiles}x{samples}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(bendy_tpu_torch.parallel.initialize)")
    world = dist.get_world_size()
    if world != tiles * samples:
        raise ValueError(f"a {tiles}x{samples} mesh needs {tiles * samples} ranks, the world "
                         f"has {world}")
    rank = dist.get_rank()
    backend = dist.get_backend()
    dev_type = torch.device(device).type
    if dev_type == "cpu" and backend != "gloo":
        raise ValueError(f"a CPU mesh runs over gloo, the world runs {backend}")
    sample_group = None
    for ti in range(tiles):  # every rank creates every group, in one order
        g = dist.new_group(ranks=[ti * samples + s for s in range(samples)])
        if ti == rank // samples:
            sample_group = g
    host_group = None if backend == "gloo" else dist.new_group(backend="gloo")
    return Mesh(tiles, samples, rank, rank_device(dev_type, rank), sample_group, host_group)


def _local_rows(mesh: Mesh, height: int) -> int:
    if height % mesh.tiles:
        raise ValueError(f"height {height} not divisible by tile axis {mesh.tiles}")
    return height // mesh.tiles


def _reduce(sums: torch.Tensor, rays: torch.Tensor, mesh: Mesh):
    """Film over the tile's sample ranks, rays (int64) over the world."""
    if mesh.samples > 1:
        dist.all_reduce(sums, group=mesh.sample_group)
    rays = rays.to(torch.int64).reshape(1)
    if mesh.world > 1:
        dist.all_reduce(rays)
    return sums, rays[0]


def render_pass_sharded(scn: SceneArrays, cam: CameraParams, seed: int, pass_idx: int,
                        mesh: Mesh, width: int, height: int, spp_local: int, subsample: int,
                        cfg: TraceConfig, output: str):
    """One progressive pass across the mesh through the plain integrator.

    This rank renders rows [ti·rows_local, ...) × samples [si·spp_local,
    ...) of a global spp_local·samples. Returns (this tile's channel sums
    [rows_local, W, 3], summed over its sample ranks, and the pass's ray
    count, int64, summed over the mesh)."""
    n = max(subsample, 1)
    nn = n * n
    rows = _local_rows(mesh, height)
    pix, sub = pass_lanes(width, rows, nn, mesh.ti * rows, scn.device)
    res = trace_core(scn, cam, render_key(seed, pass_idx), pix, sub, width, height,
                     spp_local, n, cfg, spp_total=spp_local * mesh.samples,
                     sample0=mesh.si * spp_local)
    return _reduce(pixel_sums(res, output, rows, width, nn), res.rays, mesh)


def make_kernel_pass_sharded(scn: SceneArrays, mesh: Mesh, width: int, height: int,
                             spp_local: int, subsample: int, cfg: TraceConfig, output: str,
                             tile: bool = TILE):
    """Sharded render pass running the CUDA tracer on each rank (the
    reference's ``make_pallas_pass_sharded``).

    Returns ``fn(cam_packed [1,32], seed, pass_idx) -> (this tile's rows
    [rows_local, W, 3] f32, summed over its sample ranks, and the pass's
    rays, int64, summed over the world)``. One tracer launch per rank and
    pass, adding one to ``make_kernel_pass_sharded.launches`` (and to the
    tracer wrapper's own count), then one ``accumulate`` that stores the
    rank's pixel sums and counts its rays before the reduce; on a CPU mesh
    both run their plain versions and nothing is counted. On a (1, 1) mesh
    the film is bit-equal to the unsharded pass of
    ``ops/trace_kernel.make_render_pass`` and to the Renderer's pass. With
    ``tile`` each rank feeds its rows' lanes tile-major
    (``ops/trace_kernel.render_lanes``), the same film bit for bit.
    """
    n = max(subsample, 1)
    nn = n * n
    rows = _local_rows(mesh, height)
    tracer = make_tracer(scn, width, height, spp_local, n, cfg,
                         spp_total=spp_local * mesh.samples)
    y0 = mesh.ti * rows
    pix, sub, tiled = render_lanes(scn, cfg, width, rows, spp_local, nn, y0, mesh.device, tile)
    sample0 = mesh.si * spp_local

    def run(cam_packed, seed, pass_idx):
        out, lane_rays = tracer.words(cam_packed.to(mesh.device), seed, pass_idx, pix, sub,
                                      sample0=sample0)
        if mesh.device.type == "cuda":
            make_kernel_pass_sharded.launches += 1
        sums = torch.empty((rows, width, 3), dtype=torch.float32, device=mesh.device)
        rays = torch.zeros(1, dtype=torch.int64, device=mesh.device)
        accumulate(out, lane_rays, output, nn, sums, add=False, ray_total=rays,
                   pix=pix if tiled else None, pix0=y0 * width)
        return _reduce(sums, rays, mesh)

    return run


make_kernel_pass_sharded.launches = 0


def render_film_sharded(scn: SceneArrays, cam_packed: torch.Tensor, mesh: Mesh, width: int,
                        height: int, spp_local: int, subsample: int, cfg: TraceConfig,
                        output: str, seed: int = 0, passes: int = 1):
    """Progressive multi-pass sharded render through
    :func:`make_kernel_pass_sharded`. Returns (this tile's rows
    [rows_local, W, 3] summed over the passes, spp, rays as a Python int)."""
    n = max(subsample, 1)
    fn = make_kernel_pass_sharded(scn, mesh, width, height, spp_local, n, cfg, output)
    total, rays = None, 0
    for p in range(passes):
        sums, r = fn(cam_packed, seed, p)
        total = sums if total is None else total + sums
        rays += int(r)
    return total, passes * spp_local * mesh.samples * n * n, rays


def _rank_main(rank: int, port: int, tiles: int, samples: int, device: str,
               backend: Optional[str], timeout_s: float, fn: Callable, args: tuple) -> None:
    """One spawned rank: join the world, build the mesh, run ``fn(mesh,
    *args)``, leave."""
    initialize(f"127.0.0.1:{port}", tiles * samples, rank, backend, timeout_s, device)
    try:
        fn(make_mesh(tiles, samples, device), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, tiles: int, samples: int, device: str = "cuda",
          backend: Optional[str] = None, args: tuple = (),
          timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Run ``fn(mesh, *args)`` on tiles·samples local ranks, one process each
    (start method ``spawn``: CUDA cannot be forked), joined on a free
    localhost port. ``fn`` must be importable (a module-level function).
    Raises if any rank fails (the others are ended) or if the ranks have
    not finished within ``timeout_s``; every process is ended either way."""
    import torch.multiprocessing as mp

    from bendy_tpu_torch.parallel.multihost import choose_backend

    world = tiles * samples
    choose_backend(torch.device(device).type, world, backend)  # refuse before spawning
    ctx = mp.start_processes(
        _rank_main, args=(free_port(), tiles, samples, device, backend, timeout_s, fn, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {tiles}x{samples} mesh ranks did not finish within "
                                   f"{timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


def render_scene_pass(mesh: Mesh, scene_path: str, config, width: int, height: int,
                      spp_total: int, subsample: int, seed: int, pass_idx: int,
                      out_path: str, warmup: bool = False) -> None:
    """One sharded pass of a scene file on this rank (a function for
    :func:`spawn`): the Renderer's trace config with its camera, through
    :func:`make_kernel_pass_sharded`, after one untimed pass when
    ``warmup``. Rank 0 writes ``sums`` ([H, W, 3]), ``rays`` and the wall
    ``seconds`` of the pass and gather to ``out_path`` (.npz)."""
    from bendy_tpu_torch.render import Renderer
    from bendy_tpu_torch.scene.io import load_scene

    if spp_total % mesh.samples:
        raise ValueError(f"spp {spp_total} not divisible by the samples axis {mesh.samples}")
    scene = load_scene(scene_path)
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = width / height
    r = Renderer(scene, config, device=mesh.device)
    r.camera_params(cam)
    fn = make_kernel_pass_sharded(r.arrays, mesh, width, height, spp_total // mesh.samples,
                                  subsample, r.trace_config(r.config, cam),
                                  r.config.output.value)
    if warmup:
        film_to_host0(fn(r._cam_packed, seed, pass_idx)[0], mesh)
    dist.barrier()
    t0 = time.perf_counter()
    sums, rays = fn(r._cam_packed, seed, pass_idx)
    film = film_to_host0(sums, mesh)
    rays = int(rays)
    if mesh.rank == 0:
        np.savez(out_path, sums=film, rays=rays, seconds=time.perf_counter() - t0,
                 pid=os.getpid())
