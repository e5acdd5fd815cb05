"""Branchless surface shading, formula-for-formula with
``bendy_tpu/ops/materials.py``.

Reproduces the estimator of ``Material::shade`` /
``ChunkState::sample_surface`` (``src/scene/data/material.rs:81-199``,
``src/tracer/mod.rs:454-486``):

    color = emitted + albedo · bsdf_pdf(scatter) · L(scatter) / shader_pdf

- Flat      terminates with emitted = albedo
- Diffuse   samples the 0.5 cosine / 0.5 light mixture PDF;
            bsdf_pdf = n·d/π (signed), shader_pdf = lerp(diffuse, light, 0.5);
            |shader_pdf| <= 1e-5 absorbs the path
- Metallic  reflect + roughness·hemisphere fuzz; pdf ≡ 1
- Glass     Schlick-probability reflect/refract + fuzz; pdf ≡ 1
- Emissive  terminates with emitted = albedo·intensity

Every lane evaluates every present branch and ``hit.mtype`` selects: the
plain path of the CUDA tracer, which instead runs only the lane's own
branch. Uniform slots: u0 light pick (its fraction u0·L mod 1 reused as
the cuboid face pick) · u1 mix / reflect bernoulli · u2,u3 cosine/fuzz ·
u4,u5 light point.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from . import distr
from .intersect import FACE_FRONT, FACE_VOLUME_FRONT, Hit, light_pdf
from .compiler import MAT_DIFFUSE, MAT_GLASS, MAT_METALLIC, SceneArrays
from .v3 import V3, sqrt_rn


class Shade(NamedTuple):
    emitted: V3  # radiance emitted at this event
    scatter: torch.Tensor  # [B] bool: does the path continue?
    direction: V3  # next ray direction (unit)
    weight: V3  # throughput multiplier for the next segment
    aov_albedo: V3
    aov_normal: V3
    aov_depth: torch.Tensor  # [B]


def sample_light_point(scn: SceneArrays, light_idx: torch.Tensor,
                       u_a: torch.Tensor, u_b: torch.Tensor,
                       u_face: torch.Tensor) -> V3:
    """Uniform point on light ``light_idx`` (``Object::random_point``).

    sphere: center + r·unit_sphere       (``sphere.rs:40-42``)
    rect:   center + x̂·U(-hw,hw) + ...    (``rect.rs:82-86``)
    cuboid: area-weighted face, then rect (``cuboid.rs:48-54``)

    Each lane reads its own light's row, so the cost does not grow with
    the light count.
    """
    B = u_a.shape
    dev = u_a.device
    if scn.n_lights == 0:
        return V3.zeros(B, dev)
    li = light_idx.long()
    p_s = (V3.from_array(scn.light_sph_center[li])
           + distr.unit_sphere(u_a, u_b) * scn.light_sph_radius[li])
    # first valid face whose cdf exceeds u_face
    remaining = torch.ones(B, dtype=torch.bool, device=dev)
    p_r = V3.zeros(B, dev)
    for f in range(scn.light_face_cdf.shape[1]):
        pick = remaining & scn.light_face_valid[li, f] & (u_face < scn.light_face_cdf[li, f])
        remaining = remaining & ~pick
        x = (u_a * 2.0 - 1.0) * scn.light_face_hw[li, f]
        y = (u_b * 2.0 - 1.0) * scn.light_face_hh[li, f]
        p_f = (V3.from_array(scn.light_face_center[li, f])
               + V3.from_array(scn.light_face_x[li, f]) * x
               + V3.from_array(scn.light_face_y[li, f]) * y)
        p_r = V3.where(pick, p_f, p_r)
    return V3.where(scn.light_kind[li] == 0, p_s, p_r)


def shade_surface(
    dir_in: V3,
    hit: Hit,
    scn: SceneArrays,
    u: Sequence[torch.Tensor],
    clip_min: float,
    clip_max: float,
    has_diffuse: bool = True,
    has_metallic: bool = True,
    has_glass: bool = True,
) -> Shade:
    """Shade surface-face lanes.

    ``has_diffuse`` / ``has_metallic`` / ``has_glass`` are static scene
    facts: a branch whose material kind no primitive carries never wins a
    select, so skipping it is exact.
    """
    B = dir_in.x.shape
    dev = dir_in.x.device
    n = hit.normal
    pos = hit.position
    albedo = hit.albedo
    mtype = hit.mtype

    # --- diffuse: mixture of cosine BSDF and next-event light sampling ----
    if has_diffuse:
        nl = scn.n_lights
        scaled = u[0] * nl
        # float -> int truncates toward zero, as jax's astype does
        light_idx = torch.clamp(scaled.to(torch.int32), 0, nl - 1)
        u_face = scaled - torch.floor(scaled)  # independent uniform given the pick
        d_cos = distr.cosine_hemisphere(n, u[2], u[3])
        lp = sample_light_point(scn, light_idx, u[4], u[5], u_face)
        d_light = (lp - pos).normalize()
        pick_light = u[1] < 0.5  # gen_bool(0.5) (``material.rs:269-274``)
        d_diff = V3.where(pick_light, d_light, d_cos)
        pdf_cos = n.dot(d_diff) * (1.0 / math.pi)  # signed (``material.rs:301-303``)
        pdf_light = light_pdf(pos, d_diff, clip_min, clip_max, scn, light_idx)
        pdf_mix = pdf_cos + (pdf_light - pdf_cos) * 0.5  # lerp(a, b, 0.5)
        absorbed = torch.abs(pdf_mix) <= 1e-5  # (``material.rs:279-286``)
        pdf_mix_safe = torch.where(absorbed, 1.0, pdf_mix)
        w_diff = albedo * (pdf_cos / pdf_mix_safe)

    if has_metallic or has_glass:
        # the hemisphere fuzz vector is shared by both specular kinds
        fuzz = distr.unit_hemisphere(n, u[2], u[3])

    if has_metallic:
        d_metal = (dir_in.reflect(n) + fuzz * hit.rough).normalize()

    if has_glass:
        is_front = (hit.face == FACE_FRONT) | (hit.face == FACE_VOLUME_FRONT)
        ior_eff = torch.where(is_front, 1.0 / hit.ior, hit.ior)
        cos_theta = torch.clamp_max((-dir_in).dot(n), 1.0)
        sin_theta = sqrt_rn(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
        fr = dir_in.fresnel(n, ior_eff)
        do_reflect = (ior_eff * sin_theta > 1.0) | (u[1] < fr)
        d_glass_base = V3.where(do_reflect, dir_in.reflect(n), dir_in.refract(n, ior_eff))
        d_glass = (d_glass_base + fuzz * hit.rough).normalize()

    # --- select by material type, in the reference's nesting order (the
    # last present kind is the select default) ----------------------------
    kinds = []
    if has_diffuse:
        kinds.append((MAT_DIFFUSE, d_diff))
    if has_metallic:
        kinds.append((MAT_METALLIC, d_metal))
    if has_glass:
        kinds.append((MAT_GLASS, d_glass))

    if not kinds:
        # flat/emissive-only scene: every surface event terminates
        scatter = torch.zeros(B, dtype=torch.bool, device=dev)
        direction = dir_in
        weight = V3.zeros(B, dev)
    else:
        scatter = torch.zeros(B, dtype=torch.bool, device=dev)
        for code, _ in kinds:
            is_k = mtype == code
            if code == MAT_DIFFUSE:
                is_k = is_k & ~absorbed
            scatter = scatter | is_k
        direction = kinds[-1][1]
        for code, d in reversed(kinds[:-1]):
            direction = V3.where(mtype == code, d, direction)
        if has_diffuse and len(kinds) > 1:
            weight = V3.where(mtype == MAT_DIFFUSE, w_diff, albedo)
        elif has_diffuse:
            weight = w_diff
        else:
            weight = albedo
    weight = V3.where(scatter, weight, V3.zeros(B, dev))

    # --- AOVs: terminating lanes report ColorData::from_emitted ----------
    return Shade(
        emitted=hit.emitted,
        scatter=scatter,
        direction=direction,
        weight=weight,
        aov_albedo=V3.where(scatter, albedo, hit.emitted),
        aov_normal=V3.where(scatter, n, V3.zeros(B, dev)),
        aov_depth=torch.where(scatter, hit.t, math.inf),
    )
