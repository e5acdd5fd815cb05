"""One render pass of the plain reference over any set of pixels.

The program renders a pass as one lane per (pixel, subpixel) that traces
its samples in sequence; the stream id of a sample is global,
``(pix·spp_total + s)·nn + sub``, so each sample's path depends on nothing
but its id and the pass's key. Here every (pixel, subpixel, sample) is a
lane of its own (``trace_core`` with one sample a lane and a per-lane
``sample0``), so the loop lasts as long as the longest single path, not
the longest run of ``spp`` paths, and any subset of pixels can be
recomputed alone. The sums are then folded as the program folds them: a
lane's samples in sample order from 0, ``((0 + r0) + r1) + ...``, then a
pixel's subpixels in order, ``((s0 + s1) + s2) + ...``.

``trace_config`` derives the static knobs from the scene as the
program's ``Renderer.trace_config`` does (the thresholds, the material
facts, the camera's frustum and focus), since some of them select another
rounding (the polynomial sin/cos of ``frustum_poly``, the looped masses).
"""

from __future__ import annotations

import contextlib
from dataclasses import fields

import numpy as np
import torch

from .camera import CameraParams
from .compiler import MAT_DIFFUSE, MAT_GLASS, MAT_METALLIC, SceneArrays, compile_scene
from .geodesic import GeoParams, geo_from_dict
from .graph import Scene, Sphere
from .rng import render_key
from .wavefront import TraceConfig, trace_core

LOOP_SWEEP_THRESHOLD = 192
LIGHT_LOOP_THRESHOLD = 64
MASS_LOOP_THRESHOLD = 8
BLOCK_LANES = 1 << 21  # lanes of one trace_core call


def camera_params(scene: Scene, camera_ref: int, device) -> CameraParams:
    """The camera's scalars, rounded to f32 as the program packs them, then
    held in the default float dtype."""
    obj = scene.get_object(camera_ref)
    cam = obj.as_camera()
    world = obj.transform.world
    yfov = 2.0 * np.arctan2(cam.sensor_size, 2.0 * cam.focal_length)
    focus = -1.0 if cam.focus is None else cam.focus
    scal = np.asarray([cam.sensor_size, cam.focal_length, cam.aspect_ratio, cam.fstop,
                       focus, yfov], np.float32)
    rot = np.asarray(world[:, :3], np.float32).reshape(3, 3)
    tr = np.asarray(world[:, 3], np.float32)
    fdt = torch.get_default_dtype()

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=fdt)

    return CameraParams(sensor_size=t(scal[0]), focal_length=t(scal[1]),
                        aspect_ratio=t(scal[2]), fstop=t(scal[3]), focus=t(scal[4]),
                        rotation=t(rot), translation=t(tr), yfov=t(scal[5]))


def trace_config(scene: Scene, arrays: SceneArrays, camera_ref: int, max_bounces: int = 8,
                 max_volume_bounces: int = 32, clip_min: float = 0.01,
                 clip_max: float = 1000.0, volume_step: float = 0.1,
                 vol_sampling: str = "trilinear") -> TraceConfig:
    """The static knobs of a FULL-output render of ``scene`` from its
    camera ``camera_ref``."""
    cam = scene.get_object(camera_ref).as_camera()
    yfov = 2.0 * np.arctan2(cam.sensor_size, 2.0 * cam.focal_length)
    host = arrays.host_copy()
    mtypes = set(host.sph_mtype.tolist()) | set(host.rct_mtype.tolist())
    block = getattr(scene, "geodesic", None)
    prims = arrays.n_spheres + arrays.n_trace_rects + arrays.n_boxes
    return TraceConfig(
        max_bounces=max_bounces,
        max_volume_bounces=max_volume_bounces,
        clip_min=clip_min,
        clip_max=clip_max,
        volume_step=volume_step,
        vol_nearest=vol_sampling == "nearest",
        frustum_poly=0.5 * yfov * max(1.0, cam.aspect_ratio) * 1.05 < 1.2,
        has_volumes=any(isinstance(o.inner, Sphere) and o.inner.volume is not None
                        for o in scene.iter()),
        geodesic=any(o.tag is not None and o.tag.startswith("mass:") for o in scene.iter()),
        geo=geo_from_dict(block) if block else GeoParams(),
        looped_sweep=prims > LOOP_SWEEP_THRESHOLD,
        looped_lights=arrays.n_lights > LIGHT_LOOP_THRESHOLD,
        looped_masses=arrays.n_masses > MASS_LOOP_THRESHOLD,
        has_diffuse=MAT_DIFFUSE in mtypes,
        has_metallic=MAT_METALLIC in mtypes,
        has_glass=MAT_GLASS in mtypes,
        has_dof=cam.focus is not None and cam.focus > 0.0,
        want_aovs=False,
    )


def scene_arrays(scene: Scene, device) -> SceneArrays:
    """The scene's tables on ``device``, float leaves in the default dtype."""
    arrays = compile_scene(scene, device)
    fdt = torch.get_default_dtype()
    if fdt == torch.float32:
        return arrays
    cast = SceneArrays(**{
        f.name: (getattr(arrays, f.name).to(fdt) if getattr(arrays, f.name).is_floating_point()
                 else getattr(arrays, f.name))
        for f in fields(SceneArrays)
    })
    object.__setattr__(cast, "_host", arrays.host_copy())
    return cast


def pass_sums(arrays: SceneArrays, cam: CameraParams, cfg: TraceConfig, seed: int,
              pass_idx: int, pixels: torch.Tensor, width: int, height: int, spp: int,
              subsample: int, block_lanes: int = BLOCK_LANES) -> tuple[torch.Tensor, dict]:
    """Radiance sums [P,3] of one pass at the global pixel ids ``pixels``
    ([P] int64), and the pass's counts over those pixels: ``rays`` (traced
    segments), ``near_steps`` (RK4 chords near a mass) and ``vol_events``."""
    key = render_key(seed, pass_idx)
    dev = pixels.device
    n = max(subsample, 1)
    nn = n * n
    per_pixel = nn * spp
    step = max(1, block_lanes // per_pixel)
    out = []
    counts = dict(rays=0, near_steps=0, vol_events=0)
    for p0 in range(0, pixels.numel(), step):
        pix_blk = pixels[p0:p0 + step]
        P = pix_blk.numel()
        # lanes [P, nn, spp]: pixel, subpixel, sample
        pix = pix_blk.view(P, 1, 1).expand(P, nn, spp).reshape(-1)
        sub = torch.arange(nn, device=dev).view(1, nn, 1).expand(P, nn, spp).reshape(-1)
        smp = torch.arange(spp, device=dev).view(1, 1, spp).expand(P, nn, spp).reshape(-1)
        res = trace_core(arrays, cam, key, pix, sub, width, height, 1, subsample, cfg,
                         spp_total=spp, sample0=smp)
        chans = []
        for c in res.radiance:
            r = c.view(P, nn, spp)
            acc = torch.zeros((P, nn), dtype=r.dtype, device=dev)
            for s in range(spp):
                acc = acc + r[:, :, s]
            pix_sum = acc[:, 0]
            for j in range(1, nn):
                pix_sum = pix_sum + acc[:, j]
            chans.append(pix_sum)
        out.append(torch.stack(chans, dim=-1))
        lc = res.lane_counts
        counts["rays"] += int(lc["rays"].sum())
        counts["near_steps"] += int(lc["near_steps"].sum())
        counts["vol_events"] += int(lc["vol_events"].sum())
    return torch.cat(out), counts


@contextlib.contextmanager
def default_dtype(dtype: torch.dtype):
    """The reference's floats in ``dtype`` inside the block (the control
    computes in a lower precision than the configuration states)."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)
