"""Camera ray generation: jittered frustum rays + thin-lens defocus.

Counterpart of ``bendy_tpu/ops/camera.py`` (reference
``src/tracer/mod.rs:244-302``, ``src/tracer/ray.rs:103-113``):

- yfov = 2·atan2(sensor_size, 2·focal_length); xfov = yfov·aspect — the
  horizontal FOV scales the *angle*, not the tangent.
- The frustum ray is the YXZ Euler rotation of -Z by (-xfov·u/2,
  -yfov·v/2): d = (-cos(xrot)·sin(yrot), sin(xrot), -cos(xrot)·cos(yrot)).
- NDC: u = x·(2/W) - 1 + subpixel·(2/W) + U(±(2/W)/(2n)).
- The camera transform translates the origin but does not rotate it; the
  direction is rotated and re-normalized.
- Thin lens: aperture = focal/(2·fstop); a center-heavy unit-disk sample
  (⊥ -Z) is rotated into world space; focus distance divides by |d.z|
  *before* the camera rotation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .distr import sin_cos_small, sin_cos_tau
from .rng import CAMERA_TAG, lane_uniforms
from .v3 import V3


class CameraParams(NamedTuple):
    sensor_size: torch.Tensor  # [] f32
    focal_length: torch.Tensor
    aspect_ratio: torch.Tensor
    fstop: torch.Tensor
    focus: torch.Tensor  # [] f32; <= 0 means no defocus (focus disabled)
    rotation: torch.Tensor  # [3,3] world rotation (linear part)
    translation: torch.Tensor  # [3]
    yfov: torch.Tensor  # [] f32 = 2·atan2(sensor, 2·focal), host-computed


def rotate(m: torch.Tensor, v: V3) -> V3:
    """Apply a [3,3] rotation to a V3 of [B] tensors."""
    return V3(
        m[0, 0] * v.x + m[0, 1] * v.y + m[0, 2] * v.z,
        m[1, 0] * v.x + m[1, 1] * v.y + m[1, 2] * v.z,
        m[2, 0] * v.x + m[2, 1] * v.y + m[2, 2] * v.z,
    )


def ndc_base(width: int, height: int, subsample: int, px, py, si, sj):
    """Jitter-free NDC base per lane (``tracer/mod.rs:271-275``)."""
    n = max(subsample, 1)
    pw = 2.0 / width
    ph = 2.0 / height
    u = px * pw - 1.0 + (si / n) * pw
    v = py * ph - 1.0 + (sj / n) * ph
    return u, v


def camera_ray(
    cam: CameraParams,
    width: int,
    height: int,
    subsample: int,
    key: tuple,
    sample_id: torch.Tensor,
    uv_base: tuple,
    poly_trig: bool = False,
    has_dof: bool = True,
) -> tuple[V3, V3]:
    """One primary ray per lane.

    ``sample_id`` is the *global* (pixel, sample, subpixel) stream id; it
    keys the jitter/defocus draws, so any chunking of lanes produces the
    same rays. ``uv_base`` is the per-lane jitter-free NDC (:func:`ndc_base`).
    ``poly_trig`` uses the range-free polynomials for the frustum angles
    (the renderer sets it when the FOV bounds them below ~1.2 rad).
    """
    n = max(subsample, 1)
    pw = 2.0 / width
    ph = 2.0 / height
    uj = lane_uniforms(key, sample_id, CAMERA_TAG, 4)

    u_base, v_base = uv_base
    u = u_base + (uj[0] - 0.5) * (pw / n)
    v = v_base + (uj[1] - 0.5) * (ph / n)

    yfov = cam.yfov
    xfov = yfov * cam.aspect_ratio
    yrot = xfov * 0.5 * -u
    xrot = yfov * 0.5 * -v
    if poly_trig:
        sin_x, cos_x = sin_cos_small(xrot)
        sin_y, cos_y = sin_cos_small(yrot)
    else:
        cos_x, sin_x = torch.cos(xrot), torch.sin(xrot)
        cos_y, sin_y = torch.cos(yrot), torch.sin(yrot)
    d_frustum = V3(-cos_x * sin_y, sin_x, -cos_x * cos_y)

    d_world = rotate(cam.rotation, d_frustum).normalize()
    zero = torch.zeros_like(u)
    origin = V3(zero + cam.translation[0], zero + cam.translation[1],
                zero + cam.translation[2])

    # thin-lens defocus (``tracer/mod.rs:286-302``); ``has_dof=False`` is a
    # static camera fact (focus is None) and drops the block entirely
    if not has_dof:
        return origin, d_world
    # unit_disk about -Z: its Duff frame is t=(1,0,0), b=(0,-1,0), so the
    # disk sample is (cos, -sin, 0)·r
    sin1, cos1 = sin_cos_tau(uj[2])
    aperture = 0.5 * cam.focal_length / cam.fstop
    dx = (cos1 * uj[3]) * aperture
    dy = (-sin1 * uj[3]) * aperture
    m = cam.rotation
    defocus_offset = V3(
        m[0, 0] * dx + m[0, 1] * dy,
        m[1, 0] * dx + m[1, 1] * dy,
        m[2, 0] * dx + m[2, 1] * dy,
    )
    frac_f_z = cam.focus / torch.abs(d_frustum.z)
    origin_dof = origin + defocus_offset
    dir_dof = (d_world * frac_f_z - defocus_offset).normalize()

    use_dof = cam.focus > 0.0
    origin = V3.where(use_dof, origin_dof, origin)
    direction = V3.where(use_dof, dir_dof, d_world)
    return origin, direction
