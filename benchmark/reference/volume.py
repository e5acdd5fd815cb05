"""Participating media: density lookup + probabilistic scattering.

Counterpart of ``bendy_tpu/ops/volume.py``; reproduces ``Volume::shade``
and ``DensityMap::sample`` (``src/scene/data/volume.rs:26-67,140-166``):

- normalized coordinate from the hit sphere's bounding box (volume.rs:32-34)
- scatter probability = step · density(coord), no exponential attenuation
  (volume.rs:36-38)
- on scatter: isotropic new direction, origin jittered up to one step
  backwards for *interior* events, albedo 0.8 (volume.rs:38-53)
- otherwise the ray passes through unattenuated (volume.rs:54-59)

:func:`density_sample` is the plain version of the density lookup inside
the CUDA tracer's volume instantiation (``csrc/trace_surface.cu``), which
repeats it operation for operation: a direct gather of the 8 grid corners
and a nested lerp. Its semantics are those of the reference's f32 einsum
branch (``volume.py:218-245``), not of either TPU kernel form: the sparse
scalar unroll over nonzero cells and the dense bf16 one-hot brick fetch
on the MXU exist because a TPU kernel cannot gather. One gather serves
sparse and dense grids alike, so the brick table (``pack_vol_operand``,
``_density_operand``, ``_fetch_*``, ``density_fetch_*``) and the
``VOL_*`` fetch knobs are not ported.

Uniform layout (shares the iteration block with surface shading):
    u0 scatter Bernoulli · u1 back jitter · u2,u3 isotropic direction
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .distr import unit_sphere
from .intersect import FACE_VOLUME, Hit
from .compiler import SceneArrays
from .v3 import V3

SCATTER_ALBEDO = 0.8  # volume.rs:38-53


def _axis(c: torch.Tensor, hi: torch.Tensor, n: int, nearest: bool):
    """Corner pair and lerp weights along one axis: (i0, i1, w0, w1).

    ``c = clamp(coord, 0, 1)·hi``. Trilinear: ``i0 = floor(c)``,
    ``i1 = min(i0 + 1, hi)``, weights ``1 − f`` and ``f``; when the far
    corner is clamped onto the near one it gets the einsum's single weight
    ``(1 − f) + f`` and the second term weighs 0. Nearest: ``floor(c + 0.5)``
    with weight 1. Indices are clamped into the padded grid, which changes
    no finite coordinate and keeps a NaN one (a lane without a volume
    event, masked by the caller) in bounds.
    """
    c = torch.clamp(c, 0.0, 1.0) * hi
    if nearest:
        i = torch.clamp(torch.floor(c + 0.5).to(torch.int64), 0, n - 1)
        one = torch.ones_like(c)
        return i, i, one, one * 0.0
    c0 = torch.floor(c)
    f = c - c0
    i0 = c0.to(torch.int64)
    i1 = torch.minimum(i0 + 1, hi.to(torch.int64))
    same = i1 == i0
    w0 = torch.where(same, (1.0 - f) + f, 1.0 - f)
    w1 = torch.where(same, 0.0, f)
    return torch.clamp(i0, 0, n - 1), torch.clamp(i1, 0, n - 1), w0, w1


def density_sample(scn: SceneArrays, hit: Hit, coord: V3, nearest: bool = False) -> torch.Tensor:
    """Density at the normalized ``coord`` of each lane (``volume.rs:140-166``).

    The grid is ``scn.vol_grid[max(hit.vol_grid, 0)]`` of the compiler's
    common padded ``[G, D, H, W]`` stack; grid coordinates scale by the
    hit sphere's own ``(w−1, h−1, d−1)`` (``hit.vol_size``), so weights
    never reach the padding. x indexes W, y indexes H, z indexes D. The
    lerp reduces over x, then y, then z, in the einsum's order.
    ``nearest=True`` selects ``SamplingMode::Nearest`` (``volume.rs:146-150``).
    """
    G, D, H, W = scn.vol_grid.shape
    x0, x1, wx0, wx1 = _axis(coord.x, hit.vol_size.x, W, nearest)
    y0, y1, wy0, wy1 = _axis(coord.y, hit.vol_size.y, H, nearest)
    z0, z1, wz0, wz1 = _axis(coord.z, hit.vol_size.z, D, nearest)
    g = torch.clamp(hit.vol_grid.to(torch.int64), 0, G - 1)
    flat = scn.vol_grid.reshape(-1)

    def row(z, y):  # lerp over x at (z, y)
        base = ((g * D + z) * H + y) * W
        return flat[base + x0] * wx0 + flat[base + x1] * wx1

    def plane(z):  # lerp over y at z
        return row(z, y0) * wy0 + row(z, y1) * wy1

    return plane(z0) * wz0 + plane(z1) * wz1


class VolumeShade(NamedTuple):
    scattered: torch.Tensor  # [B] bool: a scattering event happened
    origin: V3  # next ray origin
    direction: V3  # next ray direction
    weight: torch.Tensor  # [B] throughput multiplier (0.8 on scatter, 1 otherwise)


def volume_shade(dir_in: V3, hit: Hit, scn: SceneArrays, u: Sequence[torch.Tensor],
                 step: float, nearest: bool = False) -> VolumeShade:
    """One probabilistic scattering decision at a volume event."""
    coord = (hit.position - hit.bbox_min) / hit.bbox_size
    density = step * density_sample(scn, hit, coord, nearest=nearest)
    scattered = u[0] < density  # covers density >= 1 too (``volume.rs:38``)

    # interior events jitter the origin up to one step backwards (``volume.rs:40-42``)
    back = V3.where(hit.face == FACE_VOLUME, dir_in * (step * u[1]),
                    V3.zeros(u[0].shape, u[0].device))
    scatter_org = hit.position - back
    scatter_dir = unit_sphere(u[2], u[3])

    origin = V3.where(scattered, scatter_org, hit.position)
    direction = V3.where(scattered, scatter_dir, dir_in)
    weight = torch.where(scattered, SCATTER_ALBEDO, 1.0)
    return VolumeShade(scattered=scattered, origin=origin, direction=direction, weight=weight)
