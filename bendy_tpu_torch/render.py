"""Renderer front-end: configs, pass scheduling, channel selection.

Counterpart of ``bendy_tpu/render.py``; the API mirrors the reference's
tracer layer (``src/tracer/mod.rs:16-230``): ``Config`` (static knobs),
``RenderConfig`` (per-call overrides), ``Subsample``, ``Output``,
``Status`` — with the same defaults.

The renderer runs on one ``device``, the card unless the caller asks for
the CPU. On a CUDA device each pass is one launch of the hand-written
tracer kernel (``ops/trace_kernel.py``: the surface kernel, its geodesic
instantiation for scenes with masses, or its volume instantiation for
scenes with density grids, with or without masses; past
``MASS_LOOP_THRESHOLD`` masses the looped-mass forms) per row chunk; on
``device="cpu"`` it runs the plain PyTorch integrator. Without a card the
default raises; nothing falls back to another path.

Divergence note (as in ``bendy_tpu``): ``ChunkConfig::with_configs``
assigns ``render.max_bounces`` to ``max_volume_bounces``
(``src/tracer/mod.rs:224``); ``merged_config`` implements the evident
intent (the reference keeps the quirk as an opt-in for parity experiments).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from bendy_tpu_torch import telemetry
from bendy_tpu_torch.film import DeviceFilm, Film
from bendy_tpu_torch.geodesic import GeoParams, geo_from_dict
from bendy_tpu_torch.ops.camera import CameraParams
from bendy_tpu_torch.ops.trace_kernel import (
    make_render_pass,
    pack_camera_host,
    pass_lanes,
    pixel_sums,
    unpack_camera,
)
from bendy_tpu_torch.ops.wavefront import TraceConfig, trace_core
from bendy_tpu_torch.scene.compiler import (
    MAT_DIFFUSE,
    MAT_GLASS,
    MAT_METALLIC,
    SceneArrays,
    compile_scene,
)
from bendy_tpu_torch.scene.graph import Scene, Sphere
from bendy_tpu_torch.utils.device import resolve_device
from bendy_tpu_torch.utils.rng import render_key


LOOP_SWEEP_THRESHOLD = 192  # primitives (spheres + traced rects + boxes)
#   above which the reference sweeps primitives with loops over row tables
#   (``bendy_tpu/render.py:108``), and LIGHT_LOOP_THRESHOLD the LIGHT-flagged
#   objects above which it sweeps lights so (``render.py:130``). Both only
#   set TraceConfig.looped_sweep / looped_lights here: the port's sweeps are
#   run-time loops at any count, and the looped and unrolled forms compute
#   the same winners (cloud_field, prim_grid_256 render as any scene).
LIGHT_LOOP_THRESHOLD = 64

MASS_LOOP_THRESHOLD = 8  # geodesic point masses above which the reference
#   sweeps masses with loops over a mass table (``bendy_tpu/render.py:142``),
#   recomputing h² per RK4 stage: a different discretization from the
#   frozen-h² unroll. The one threshold that changes the image: above it
#   (mass_cluster) the port takes the same looped form
#   (TraceConfig.looped_masses; the kernel's LOOPM instantiation).


class Output(enum.Enum):
    FULL = "full"
    ALBEDO = "albedo"
    NORMAL = "normal"
    DEPTH = "depth"

    def color_space(self) -> str:
        """Default preview conversion per channel (``src/main.rs:40-47``)."""
        return "normal" if self is Output.NORMAL else "srgb"


class Status(enum.Enum):
    DONE = "done"
    IN_PROGRESS = "in_progress"


@dataclass(frozen=True)
class Subsample:
    """n×n subpixel grid; n<=1 means none (``tracer/mod.rs:47-106``)."""

    n: int = 1

    @property
    def subpixel_count(self) -> int:
        return max(self.n, 1) ** 2


@dataclass(frozen=True)
class Config:
    """Defaults = ``Config::DEFAULT`` (``src/tracer/mod.rs:29-38``)."""

    max_bounces: int = 8
    max_volume_bounces: int = 32
    clip_min: float = 0.01
    clip_max: float = 1000.0
    volume_step: float = 0.1
    vol_sampling: str = "trilinear"  # 'trilinear' | 'nearest'
    output: Output = Output.FULL
    geo: Optional[GeoParams] = None


@dataclass(frozen=True)
class RenderConfig:
    """Per-call overrides (``src/tracer/mod.rs:117-157``)."""

    samples: int = 64
    subsample: Subsample = Subsample(1)
    output: Optional[Output] = None
    max_bounces: Optional[int] = None
    max_volume_bounces: Optional[int] = None
    volume_step: Optional[float] = None


def merged_config(main: Config, render: RenderConfig) -> Config:
    """Overlay per-call overrides (``ChunkConfig::with_configs``)."""
    max_vb = render.max_volume_bounces
    return replace(
        main,
        output=render.output or main.output,
        max_bounces=main.max_bounces if render.max_bounces is None else render.max_bounces,
        max_volume_bounces=main.max_volume_bounces if max_vb is None else max_vb,
        volume_step=main.volume_step if render.volume_step is None else render.volume_step,
    )


def render_pass(
    scn: SceneArrays,
    cam: CameraParams,
    seed: int,
    pass_idx: int,
    y_offset: int,
    width: int,
    height: int,
    rows: int,
    spp: int,
    subsample: int,
    cfg: TraceConfig,
    output: str,
):
    """One pass over image rows [y_offset, y_offset+rows) through the plain
    integrator, on the scene's device: each lane is a (pixel, subpixel)
    and traces its spp samples in sequence (ray regeneration).

    Returns (per-pixel channel sums [rows,W,3], traced-ray count int64).
    Sample ids are global, so any row chunking gives the same image.
    """
    nn = max(subsample, 1) ** 2
    pix, sub = pass_lanes(width, rows, nn, y_offset, scn.device)
    res = trace_core(scn, cam, render_key(seed, pass_idx), pix, sub, width,
                     height, spp, subsample, cfg)
    return pixel_sums(res, output, rows, width, nn), res.rays


class Renderer:
    """Progressive scene renderer (the reference's ``Tracer``) on ``device``.

    ``max_lanes`` bounds the lanes of one launch; larger renders are
    chunked by image rows. Chunking is invisible: lane ids (hence RNG
    streams) are global, so any chunking yields the same image.
    """

    def __init__(self, scene: Scene, config: Config = Config(),
                 max_lanes: int = 1 << 21, device="cuda") -> None:
        self.device = resolve_device(device)
        self.config = config
        self.scene = scene
        self.max_lanes = max_lanes
        # every pass adds its rays here on the device (int64: exact), and a
        # profiled pass the tracer's warp use and volume events
        # (telemetry.counters)
        self._rays = torch.zeros(1, dtype=torch.int64, device=self.device)
        # words in the order of telemetry.COUNTERS
        self._counts = torch.zeros(3, dtype=torch.int64, device=self.device)
        self._pass_cache: dict = {}
        self._cam_key = None
        self.has_volumes = any(
            isinstance(o.inner, Sphere) and o.inner.volume is not None for o in scene.iter()
        )
        self.has_masses = any(
            o.tag is not None and o.tag.startswith("mass:") for o in scene.iter()
        )
        with telemetry.one_off("scene.compile"):
            self.arrays = compile_scene(scene, self.device)
            # static material facts: branches for kinds no primitive carries
            # are dead code in every lane, so the integrator drops them (exact)
            host = self.arrays.host_copy()
            mtypes = set(host.sph_mtype.tolist()) | set(host.rct_mtype.tolist())
        self.has_diffuse = MAT_DIFFUSE in mtypes
        self.has_metallic = MAT_METALLIC in mtypes
        self.has_glass = MAT_GLASS in mtypes
        self.prim_count = (self.arrays.n_spheres + self.arrays.n_trace_rects
                           + self.arrays.n_boxes)

    @property
    def rays_traced(self) -> int:
        """Total traced rays, exact (an int64 counter on the device that
        every pass adds to, not the reference's f32): reading it waits for
        the queued passes, once; rendering itself never waits on it."""
        return int(self._rays.item())

    @rays_traced.setter
    def rays_traced(self, value: int) -> None:
        self._rays.fill_(int(value))

    def camera_params(self, camera_ref: int) -> CameraParams:
        """Camera params on the device, cached until the camera changes.

        All 18 scalars go over in ONE packed [1,32] transfer (the kernel's
        camera layout); a progressive render with a static camera costs no
        host->device traffic per pass.
        """
        obj = self.scene.get_object(camera_ref)
        cam = obj.as_camera()
        if cam is None:
            raise ValueError("expected a camera object")
        world = obj.transform.world
        vec = pack_camera_host(
            cam.sensor_size, cam.focal_length, cam.aspect_ratio, cam.fstop,
            -1.0 if cam.focus is None else cam.focus,
            2.0 * np.arctan2(cam.sensor_size, 2.0 * cam.focal_length),
            world[:, :3], world[:, 3],
        )
        key = vec.tobytes()
        if self._cam_key != key:
            self._cam_packed = torch.from_numpy(vec).to(self.device)  # the one transfer
            self._cam_params = unpack_camera(self._cam_packed)
            self._cam_key = key
        return self._cam_params

    def trace_config(self, cfg: Config, camera_ref: Optional[int] = None) -> TraceConfig:
        """The static trace knobs of ``cfg`` for this scene and camera.

        There is no counterpart of the reference's ``vol_operand`` policy
        (``bendy_tpu/render.py:460-479``): the TPU kernel picks between a
        scalar unroll over nonzero grid cells and a one-hot brick fetch on
        the MXU because it cannot gather, while the CUDA kernel reads the 8
        corners of any grid, sparse or dense, with one gather.
        """
        if cfg.vol_sampling not in ("trilinear", "nearest"):
            raise ValueError(f"unknown vol_sampling {cfg.vol_sampling!r}")
        frustum_poly = False
        has_dof = True
        if camera_ref is not None:
            cam = self.scene.get_object(camera_ref).as_camera()
            if cam is not None:
                yfov = 2.0 * np.arctan2(cam.sensor_size, 2.0 * cam.focal_length)
                # frustum angles are bounded by max(yfov, xfov)/2 (+jitter);
                # below ~1.2 rad the polynomial sin/cos is exact to f32
                frustum_poly = 0.5 * yfov * max(1.0, cam.aspect_ratio) * 1.05 < 1.2
                # focus=None is a static camera fact: the thin-lens block drops out
                has_dof = cam.focus is not None and cam.focus > 0.0
        return TraceConfig(
            max_bounces=cfg.max_bounces,
            max_volume_bounces=cfg.max_volume_bounces,
            clip_min=cfg.clip_min,
            clip_max=cfg.clip_max,
            volume_step=cfg.volume_step,
            vol_nearest=cfg.vol_sampling == "nearest",
            frustum_poly=frustum_poly,
            has_volumes=self.has_volumes,
            geodesic=self.has_masses,
            # precedence: explicit Config.geo > the scene file's "geodesic"
            # block > GeoParams defaults
            geo=cfg.geo if cfg.geo is not None else self._scene_geo(),
            looped_sweep=self.prim_count > LOOP_SWEEP_THRESHOLD,
            looped_lights=self.arrays.n_lights > LIGHT_LOOP_THRESHOLD,
            looped_masses=self.arrays.n_masses > MASS_LOOP_THRESHOLD,
            has_diffuse=self.has_diffuse,
            has_metallic=self.has_metallic,
            has_glass=self.has_glass,
            has_dof=has_dof,
            # the AOV pipeline runs only when an AOV channel is requested
            want_aovs=cfg.output is not Output.FULL,
        )

    def _scene_geo(self) -> Optional[GeoParams]:
        """GeoParams from the scene file's 'geodesic' block, or None."""
        block = getattr(self.scene, "geodesic", None)
        return geo_from_dict(block) if block else None

    def render(self, camera_ref: int, render_config: RenderConfig, film: Film,
               seed: int = 0) -> Status:
        """Render ``render_config.samples`` spp into the film, one pass.

        Early-outs on samples == 0 and otherwise reports IN_PROGRESS, like
        ``Tracer::render`` (``tracer/mod.rs:186,201``). Each row chunk is
        one tracer call and one ``accumulate`` (``ops/trace_kernel.py``),
        which adds the chunk's pixel sums into the rows of a
        :class:`DeviceFilm` on this device in place, with no sync, or stores
        them into one pass image that ``add_pass`` takes (a host
        :class:`Film`, a film elsewhere); the rays go to the device counter
        behind :attr:`rays_traced`. While a profiler records, the pass also
        counts the tracer's warp use and volume events (``telemetry.counters``).
        """
        span = telemetry.begin_render(film.passes)
        try:
            if render_config.samples == 0:
                return Status.DONE
            cfg = merged_config(self.config, render_config)
            self.camera_params(camera_ref)
            tcfg = self.trace_config(cfg, camera_ref)
            W, H = film.width, film.height
            nn = render_config.subsample.subpixel_count
            n = max(render_config.subsample.n, 1)
            rows_chunk = min(H, max(1, self.max_lanes // max(W * nn, 1)))
            in_place = isinstance(film, DeviceFilm) and film.sum.device == self.device
            dst = film.sum if in_place else torch.empty((H, W, 3), dtype=torch.float32,
                                                        device=self.device)
            counts = telemetry.tally(self._counts) if telemetry.ACTIVE else None
            warp_use, vol_events = (None, None) if counts is None else (counts[:2], counts[2:])
            for y0 in range(0, H, rows_chunk):
                rows = min(rows_chunk, H - y0)
                key = (W, H, rows, render_config.samples, n, tcfg, cfg.output.value)
                if key not in self._pass_cache:
                    with telemetry.one_off("pass.build"):
                        self._pass_cache[key] = make_render_pass(
                            self.arrays, W, H, rows, render_config.samples, n, tcfg,
                            cfg.output.value,
                        )
                self._pass_cache[key](self._cam_packed, seed, film.passes, y0, dst[y0:y0 + rows],
                                      add=in_place, rays=self._rays, loop_use=warp_use,
                                      vol_use=vol_events)
            if in_place:
                film.count_pass(render_config.samples * nn)
            else:
                film.add_pass(dst, render_config.samples * nn)
            return Status.IN_PROGRESS

        finally:
            telemetry.end_render(span)
