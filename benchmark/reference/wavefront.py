"""Wavefront path-tracing integrator with ray regeneration.

Counterpart of ``bendy_tpu/ops/wavefront.py``. The reference integrates by
recursion (``ChunkState::sample``, ``src/tracer/mod.rs:322-342``); here one
loop runs over a batch of lanes. Each lane owns one (pixel, subpixel) and
traces its ``spp`` samples in sequence: the moment a path terminates, the
lane regenerates the camera ray for its next sample.

Per-lane state machine (``MODE_*``):

    0 = path terminated (regenerate or finish) ·
    1 = surface trace (clip [clip_min, clip_max]) ·
    2 = volume march (clip [0, volume_step], ``tracer/mod.rs:382-387``)

Estimator identity that makes the flattening exact
(``tracer/mod.rs:471-482``):

    recursive:  color = emitted + w · sample(scatter, bounce+1)
    iterative:  radiance += throughput · emitted;  throughput *= w

:func:`trace_core` is the plain PyTorch version of the whole loop: every
lane steps every iteration with masked selects, and the batch stops when
no lane has work left. It is the yardstick of the CUDA tracer in
:mod:`.trace_kernel`, which runs the same per-lane state machine on one
thread per lane. The RNG is counter-based and keyed by the global
(pixel, sample, subpixel) stream id, so both give the reference's image.

Geodesic mode (scene has ``mass:<rs>`` objects, ``cfg.geodesic``): surface
propagation is stepped. Each iteration takes one adaptive RK4 step of the
ray (:mod:`bendy_tpu_torch.geodesic`: per-mass h² frozen per step, or,
with ``cfg.looped_masses``, the looped mass sweep that recomputes h² per
RK4 stage, as the reference's dispatch does), intersects along the straight chord from the old to the new point, and,
on no hit inside the chord, continues bending from the new point; lanes
in flat space (far from and receding from every mass) trace straight with
the full clip, lanes inside a horizon or past the step budget are
swallowed.

Participating media (``cfg.has_volumes``): entering a sphere that carries
a density grid (a VOLUME_FRONT hit) switches the lane to march mode; each
march step intersects ``[0, volume_step]`` ahead, where the last sphere's
interior reports a VOLUME pseudo-hit while the step ends inside it, and
:func:`bendy_tpu_torch.ops.volume.volume_shade` scatters by the local
density. A VOLUME_BACK exit returns the lane to surface mode at bounce+1
(``tracer/mod.rs:503-513``); a march longer than ``max_volume_bounces``
steps is killed at path entry. Under geodesics marching lanes step
straight with the march clip, horizon capture still applies to them, the
step budget does not, and a volume event restarts the chord clip.

The reference's looped primitive and light sweeps (``looped_sweep``,
``looped_lights``) need no other arithmetic here: the plain sweeps are
Python loops over the rows and the kernel's are run-time loops over the
shared-memory table, at any count, and the reference proves its looped
and unrolled forms equal (``tests/test_looped_sweep.py``). The reference's
``regen_every`` cadence changes no pixel (``tests/test_cadence.py``), nor
does its ``march_every`` split (``tests/test_march_cadence.py``); both
versions here run every block every iteration.

AOVs follow the reference: per sample, the first claiming event (surface
shade, environment miss, or volume *scatter*; a volume pass-through does
not claim, ``volume.rs:54-59``) fixes albedo/normal/depth; depth is
normalized and clamped per sample before accumulation
(``tracer/mod.rs:306-308``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .geodesic import (
    GeoParams,
    geo_step_begin,
    geo_step_begin_looped,
    rk4_step,
    rk4_step_looped,
)
from .camera import CameraParams, camera_ray, ndc_base
from .intersect import FACE_BACK, FACE_FRONT, FACE_VOLUME_BACK, nearest_hit
from .materials import shade_surface
from .volume import SCATTER_ALBEDO, volume_shade
from .compiler import MAT_EMISSIVE, MAT_FLAT, SceneArrays
from .rng import MASK32, lane_uniforms
from .v3 import V3

MODE_DEAD = 0
MODE_SURFACE = 1
MODE_MARCH = 2

N_UNIFORMS = 6  # see ops.materials / ops.volume uniform layouts
PENDING_CHECK = 8  # the plain loop tests for termination every N iterations
#   (one host sync each; iterating a lane with no work left is a masked no-op)


@dataclass(frozen=True)
class TraceConfig:
    """Static trace knobs (defaults = ``Config::DEFAULT``, ``tracer/mod.rs:29-38``)."""

    max_bounces: int = 8
    max_volume_bounces: int = 32
    clip_min: float = 0.01
    clip_max: float = 1000.0
    volume_step: float = 0.1
    has_volumes: bool = False  # march mode compiled in (scene has grids)
    vol_nearest: bool = False  # SamplingMode::Nearest density lookups
    #   (``volume.rs:146-150``); default Trilinear like the reference tracer
    geodesic: bool = False  # curved-ray propagation (scene has masses)
    frustum_poly: bool = False  # FOV bounds the frustum angles under
    #   ~1.2 rad -> range-free polynomial sin/cos in camera_ray
    geo: GeoParams | None = None  # geodesic knobs; None = GeoParams()
    # static scene facts (Renderer derives them from the compiled scene
    # and camera): branches for absent material kinds are dropped (exact)
    has_diffuse: bool = True
    has_metallic: bool = True
    has_glass: bool = True
    has_dof: bool = True  # camera has a focus distance (thin-lens defocus)
    want_aovs: bool = True  # False drops the AOV pipeline (FULL renders)
    # the reference's choice of looped sweeps (Renderer.trace_config derives
    # them as it does). looped_masses selects the looped mass sweep (h²
    # recomputed per RK4 stage: another rounding of the same ODE);
    # looped_sweep and looped_lights select no other arithmetic here: on
    # Hopper every sweep is one run-time loop over the table, and the
    # reference proves its two forms of those sweeps equal
    looped_sweep: bool = False
    looped_lights: bool = False
    looped_masses: bool = False

    def max_iters(self, spp: int) -> int:
        """Loop-length safety cap: per-path worst case × samples (a path
        takes at most max_bounces+1 segments, one bounce-cap kill and one
        regeneration, each segment up to max_volume_bounces+2 march steps
        with volumes; a geodesic path also up to ``geo.max_steps`` chord
        steps)."""
        per_path = self.max_bounces + 2
        if self.has_volumes:
            per_path *= self.max_volume_bounces + 2
        if self.geodesic:
            per_path += (self.geo or GeoParams()).max_steps
        return per_path * spp


@dataclass
class TraceSums:
    """Per-lane accumulations over all spp samples."""

    radiance: V3
    aov_albedo: V3
    aov_normal: V3
    aov_depth: torch.Tensor  # [B] normalized+clamped depth sum
    rays: torch.Tensor  # [] int64: total alive-lane iterations (traced rays)
    iters: torch.Tensor  # [] int64: sum over lanes of each lane's own loop
    #   length (iterations it entered with work left), as the kernel counts
    vol_events: torch.Tensor  # [] int64: volume events (density lookups),
    #   0 without volumes
    lane_counts: dict | None = None  # the per-lane counts behind the sums:
    #   rays, iters, vol_events [B] (and near_steps, RK4 steps, from trace_core)


def check_trace_args(width: int, height: int, spp_total: int, subsample: int,
                     cfg: TraceConfig) -> None:
    """Refuse RNG stream ids that would alias.

    Stream ids are u32: id = (pix·spp_total + s)·nn + sub, so the id space
    is width·height·spp_total·nn. Overflow would silently alias RNG streams
    across the image (correlated noise, no error), so refuse instead.
    """
    nn = max(subsample, 1) ** 2
    id_space = width * height * spp_total * nn
    if id_space > 0xFFFFFFFF:
        raise ValueError(
            f"RNG stream-id space {width}x{height}x{spp_total}spp x{nn}sub "
            f"= {id_space} exceeds u32 ({0xFFFFFFFF}); ids would alias and "
            "silently correlate samples across pixels. Render in multiple "
            "passes with lower spp_total (progressive film accumulation "
            "re-keys each pass) or drop --subsample."
        )


def _env_terms(scn: SceneArrays, dir: V3, clip_max: float):
    """Environment (root-material) shading on miss (``tracer/mod.rs:429-452``).

    All five material kinds collapse to a fixed color because
    ``sample_root`` ignores the scatter ray: flat/emissive contribute their
    emitted color, the rest their albedo. AOVs keep the reference's quirks
    (flat env reports black albedo; emissive env zero normal / inf depth).
    """
    mtype = int(scn.host_copy().root_mtype)
    albedo = V3.from_array(scn.root_albedo)
    emitted = V3.from_array(scn.root_emitted)
    zero = torch.zeros_like(dir.x)
    is_const = mtype in (MAT_FLAT, MAT_EMISSIVE)
    color = (emitted if is_const else albedo) + zero
    aov_albedo = V3(zero, zero, zero) if is_const else albedo + zero
    if mtype == MAT_EMISSIVE:
        return color, aov_albedo, V3(zero, zero, zero), zero + math.inf
    return color, aov_albedo, -dir, zero + clip_max


def trace_core(
    scn: SceneArrays,
    cam: CameraParams,
    key: tuple,
    pix: torch.Tensor,  # [B] global pixel index (y*W + x), int32 or int64
    sub: torch.Tensor,  # [B] subpixel index (j*n + i)
    width: int,
    height: int,
    spp: int,
    subsample: int,
    cfg: TraceConfig,
    spp_total: int | None = None,
    sample0: int = 0,
    active: torch.Tensor | None = None,
) -> TraceSums:
    """Trace spp samples for every (pixel, subpixel) lane; return sums.

    ``spp_total``/``sample0`` assign this call the samples
    [sample0, sample0+spp) of a global spp_total, keeping globally unique
    RNG stream ids. ``active`` ([B] bool, optional) marks real lanes;
    others start with their sample budget spent and return zeros.
``sample0`` may be a per-lane [B] integer tensor: each lane then traces
its own samples [sample0, sample0+spp), one lane per sample when spp is 1.
    """
    if spp_total is None:
        spp_total = spp
    check_trace_args(width, height, spp_total, subsample, cfg)
    dev = pix.device
    B = pix.shape
    n = max(subsample, 1)
    nn = n * n
    pix = pix.to(torch.int64)
    sub = sub.to(torch.int64)

    def sample_id(sample):
        """Global RNG stream id for (pixel, sample, subpixel), u32."""
        s_glob = (sample0 + sample.to(torch.int64)) & MASK32
        return (((pix * spp_total + s_glob) & MASK32) * nn + sub) & MASK32

    fdt = torch.get_default_dtype()
    ub, vb = ndc_base(width, height, n, (pix % width).to(fdt),
                      (pix // width).to(fdt), (sub % n).to(fdt),
                      (sub // n).to(fdt))
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    zb = torch.zeros(B, dtype=torch.bool, device=dev)
    zf = torch.zeros(B, device=dev)
    zv = V3(zf, zf, zf)
    sample = zi - 1
    if active is not None:
        sample = sample + (~active).to(torch.int32) * spp
    path_step = zi
    path_open = zb
    org, dirv, thr, rad = zv, zv + V3(0.0, 0.0, -1.0), zv, zv
    bounce = zi
    vbounce = zi  # march steps of the current volume crossing
    last_sph = zi - 1  # sphere row the lane is marching through
    mode = zi
    aov_open = zb
    aov_alb, aov_nrm, aov_dep = zv, zv, zf + math.inf
    acc_rad, acc_alb, acc_nrm, acc_dep = zv, zv, zv, zf
    geo = cfg.geo or GeoParams()
    geo_steps = zi  # chord steps of the current path (geodesic mode)
    fresh = torch.ones(B, dtype=torch.bool, device=dev)  # first segment after
    #   a bounce or regeneration: clip_min applies (geodesic mode)
    rays = torch.zeros(B, dtype=torch.int64, device=dev)
    lane_iters = torch.zeros(B, dtype=torch.int64, device=dev)
    vol_events = torch.zeros(B, dtype=torch.int64, device=dev)
    near_steps = torch.zeros(B, dtype=torch.int64, device=dev)  # RK4 steps (near chords)
    dep_den = cfg.clip_max - cfg.clip_min

    def depth_n(d):
        return torch.clamp((d - cfg.clip_min) / dep_den, 0.0, 1.0)

    it = 0
    cap = cfg.max_iters(spp)
    while it < cap:
        pending = (mode != MODE_DEAD) | (sample + 1 < spp)
        if it % PENDING_CHECK == 0 and not bool(pending.any()):
            break
        lane_iters = lane_iters + pending.to(torch.int64)
        # === finalize dead paths, regenerate camera rays ===================
        dead = mode == MODE_DEAD
        fin = dead & path_open
        acc_rad = acc_rad + V3.where(fin, rad, zv)
        if cfg.want_aovs:
            acc_alb = acc_alb + V3.where(fin, aov_alb, zv)
            acc_nrm = acc_nrm + V3.where(fin, aov_nrm, zv)
            acc_dep = acc_dep + torch.where(fin, depth_n(aov_dep), 0.0)
        regen = dead & (sample + 1 < spp)
        path_open = regen | (path_open & ~fin)
        path_step = torch.where(regen, 0, path_step)
        sample = sample + regen.to(torch.int32)
        sid = sample_id(torch.clamp_min(sample, 0))
        cam_org, cam_dir = camera_ray(
            cam, width, height, n, key, sid, (ub, vb),
            poly_trig=cfg.frustum_poly, has_dof=cfg.has_dof,
        )
        org = V3.where(regen, cam_org, org)
        dirv = V3.where(regen, cam_dir, dirv)
        thr = V3.where(regen, zv + 1.0, thr)
        rad = V3.where(regen, zv, rad)
        bounce = torch.where(regen, 0, bounce)
        vbounce = torch.where(regen, 0, vbounce)
        mode = torch.where(regen, MODE_SURFACE, mode)
        if cfg.want_aovs:
            aov_open = aov_open | regen
            aov_alb = V3.where(regen, zv, aov_alb)
            aov_nrm = V3.where(regen, zv, aov_nrm)
            aov_dep = torch.where(regen, math.inf, aov_dep)
        if cfg.geodesic:
            geo_steps = torch.where(regen, 0, geo_steps)
            fresh = fresh | regen

        # === bounce-cap kills at path entry (``tracer/mod.rs:323-325,352-354``)
        over = (mode == MODE_SURFACE) & (bounce > cfg.max_bounces)
        if cfg.has_volumes:
            over = over | ((mode == MODE_MARCH) & (vbounce > cfg.max_volume_bounces))
        mode = torch.where(over, MODE_DEAD, mode)

        if cfg.geodesic:
            # horizon capture swallows any alive lane, marching ones included
            # (a medium around the mass must not let straight march steps
            # tunnel through the horizon); the step budget binds surface lanes
            if cfg.looped_masses:
                captured, far_field, ds = geo_step_begin_looped(scn, org, dirv, geo,
                                                                steps=geo_steps)
            else:
                captured, far_field, ds, h2s = geo_step_begin(scn, org, dirv, geo,
                                                              steps=geo_steps)
            swallowed = captured | ((mode == MODE_SURFACE) & (geo_steps > geo.max_steps))
            mode = torch.where((mode != MODE_DEAD) & swallowed, MODE_DEAD, mode)
        alive = mode != MODE_DEAD
        march = mode == MODE_MARCH

        # === propagation segment: the RK4 chord, or a straight ray =========
        if cfg.geodesic:
            # x_next/d_next are computed for every lane and read only where
            # the chord holds no hit (geo_cont); dead lanes' values (NaN
            # included) never reach state a regeneration reads
            if cfg.looped_masses:
                x_next, d_next = rk4_step_looped(scn, org, dirv, ds)
            else:
                x_next, d_next = rk4_step(scn, org, dirv, ds, h2s=h2s)
            chord = x_next - org
            chord_len = chord.length()
            seg_dir = chord * (1.0 / torch.clamp_min(chord_len, 1e-20))
            near = (mode == MODE_SURFACE) & ~far_field
            trace_dir = V3.where(near, seg_dir, dirv)
            cmin = torch.where(fresh, cfg.clip_min, 0.0)
            cmax = torch.where(near, chord_len, cfg.clip_max)
            if cfg.has_volumes:  # marching lanes step straight
                cmin = torch.where(march, 0.0, cmin)
                cmax = torch.where(march, cfg.volume_step, cmax)
        elif cfg.has_volumes:
            trace_dir = dirv
            cmin = torch.where(march, 0.0, cfg.clip_min)
            cmax = torch.where(march, cfg.volume_step, cfg.clip_max)
        else:
            trace_dir, cmin, cmax = dirv, cfg.clip_min, cfg.clip_max

        # === one intersection sweep + shade ================================
        if cfg.has_volumes:
            hit = nearest_hit(org, trace_dir, cmin, cmax, scn, march=march,
                              last_sphere=last_sph)
        else:
            hit = nearest_hit(org, trace_dir, cmin, cmax, scn, carry_volumes=False)
        miss = alive & ~hit.valid
        if cfg.geodesic:
            geo_cont = miss & near  # no hit inside the chord: keep bending
            miss = miss & ~near  # the environment only in flat space
        surf = alive & hit.valid & ((hit.face == FACE_FRONT) | (hit.face == FACE_BACK))
        # the diffuse branch draws 6 uniforms (slots 4,5 = light point);
        # without it slots 0-3 suffice and keep their values
        u = lane_uniforms(key, sid, path_step, N_UNIFORMS if cfg.has_diffuse else 4)
        sh = shade_surface(
            trace_dir, hit, scn, u, cfg.clip_min, cfg.clip_max,
            has_diffuse=cfg.has_diffuse, has_metallic=cfg.has_metallic,
            has_glass=cfg.has_glass,
        )
        env_color, env_alb, env_nrm, env_dep = _env_terms(scn, trace_dir, cfg.clip_max)

        # === radiance & throughput =========================================
        rad = rad + V3.where(miss, thr * env_color, zv)
        rad = rad + V3.where(surf, thr * sh.emitted, zv)
        surf_cont = surf & sh.scatter
        thr = V3.where(surf_cont, thr * sh.weight, thr)

        # === continuation ray & mode transitions ===========================
        org = V3.where(surf, hit.position, org)
        dirv = V3.where(surf, sh.direction, dirv)
        mode = torch.where(alive & surf_cont, MODE_SURFACE, MODE_DEAD).to(torch.int32)
        bounce = bounce + surf_cont.to(torch.int32)
        if cfg.geodesic:
            # a surface event restarts the chord clip; a chord without a hit
            # continues along the bent ray from its end point
            fresh = (fresh | surf) & ~geo_cont
            org = V3.where(geo_cont, x_next, org)
            dirv = V3.where(geo_cont, d_next, dirv)
            mode = torch.where(geo_cont, MODE_SURFACE, mode).to(torch.int32)
            geo_steps = geo_steps + near.to(torch.int32)
            near_steps = near_steps + near.to(torch.int64)

        if cfg.want_aovs:
            claim = (surf | miss) & aov_open
            aov_alb = V3.where(claim, V3.where(surf, sh.aov_albedo, env_alb), aov_alb)
            aov_nrm = V3.where(claim, V3.where(surf, sh.aov_normal, env_nrm), aov_nrm)
            aov_dep = torch.where(claim, torch.where(surf, sh.aov_depth, env_dep), aov_dep)
            aov_open = aov_open & ~claim

        if cfg.has_volumes:
            # === volume event: march step or crossing a volume sphere ======
            vol = alive & hit.valid & (hit.face >= 2) & (hit.vol_grid >= 0)
            vs = volume_shade(trace_dir, hit, scn, u, cfg.volume_step, nearest=cfg.vol_nearest)
            thr = V3.where(vol & vs.scattered, thr * vs.weight, thr)
            org = V3.where(vol, vs.origin, org)
            dirv = V3.where(vol, vs.direction, dirv)
            # VolumeBack exits to the surface integrator at bounce+1
            # (``tracer/mod.rs:503-513``); everything else keeps marching
            vol_exit = vol & (hit.face == FACE_VOLUME_BACK)
            vol_march = vol & ~vol_exit
            mode = torch.where(vol_exit, MODE_SURFACE,
                               torch.where(vol_march, MODE_MARCH, mode)).to(torch.int32)
            bounce = bounce + vol_exit.to(torch.int32)
            vbounce = torch.where(vol_march, torch.where(march, vbounce + 1, 1), vbounce)
            last_sph = torch.where(vol_march, hit.sphere_row, last_sph)
            if cfg.geodesic:  # a volume event restarts the chord clip
                fresh = fresh | vol
            if cfg.want_aovs:
                vol_claim = vol & vs.scattered & aov_open
                aov_alb = V3.where(vol_claim, zv + SCATTER_ALBEDO, aov_alb)
                aov_nrm = V3.where(vol_claim, hit.normal, aov_nrm)
                aov_dep = torch.where(vol_claim, hit.t, aov_dep)
                aov_open = aov_open & ~vol_claim
            vol_events = vol_events + vol.to(torch.int64)

        path_step = path_step + 1
        rays = rays + alive.to(torch.int64)
        it += 1

    # fold in each lane's last completed path (not yet accumulated in-loop)
    fin = (mode == MODE_DEAD) & path_open
    radiance = acc_rad + V3.where(fin, rad, zv)
    rays_total = rays.sum()
    iters = lane_iters.sum()
    n_vol = vol_events.sum()
    lane_counts = dict(rays=rays, iters=lane_iters, vol_events=vol_events, near_steps=near_steps)
    if not cfg.want_aovs:
        # AOV slots alias the radiance (callers only read .radiance)
        return TraceSums(radiance, radiance, radiance, radiance.x, rays_total, iters, n_vol,
                         lane_counts)
    return TraceSums(
        radiance=radiance,
        aov_albedo=acc_alb + V3.where(fin, aov_alb, zv),
        aov_normal=acc_nrm + V3.where(fin, aov_nrm, zv),
        aov_depth=acc_dep + torch.where(fin, depth_n(aov_dep), 0.0),
        rays=rays_total,
        iters=iters,
        vol_events=n_vol,
        lane_counts=lane_counts,
    )
