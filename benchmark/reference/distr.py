"""Sampling distributions, formula-for-formula with ``bendy_tpu/ops/distr.py``.

Each sampler takes pre-drawn U[0,1) uniforms so the integrator can draw
one uniform block per loop iteration and feed every masked branch from it.
All inputs/outputs are SoA ([B] tensors, V3 of [B]). The trig stays the
reference's range-free polynomials (``sin_cos_tau``, ``sin_cos_small``),
not ``torch.sin``/``cos``, so the port draws the same directions; the CUDA
tracer evaluates the same polynomials.

Parity notes (reference ``src/math/distr.rs``):
- ``unit_sphere``     (distr.rs:11-21): uniform on the sphere.
- ``unit_hemisphere`` (distr.rs:49-58): intentionally NOT unit length; the
  reference uses it as a fuzz vector that gets normalized later.
- ``cosine_hemisphere`` (distr.rs:87-96): cosine-weighted, unit length.
"""

from __future__ import annotations

import math

import torch

from .v3 import V3, sqrt_rn


def sin_cos_tau(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of 2π·u for u in [0,1), as half-angle Taylor polynomials
    (h = π·(u−1/2) in [−π/2, π/2); ~4e-6 abs error)."""
    h = (u - 0.5) * math.pi
    h2 = h * h
    s_h = h * (
        1.0
        + h2 * (-1.0 / 6.0 + h2 * (1.0 / 120.0 + h2 * (-1.0 / 5040.0 + h2 * (1.0 / 362880.0))))
    )
    c_h = 1.0 + h2 * (
        -0.5
        + h2 * (1.0 / 24.0 + h2 * (-1.0 / 720.0 + h2 * (1.0 / 40320.0 + h2 * (-1.0 / 3628800.0))))
    )
    # angle = 2h + π:  sin = -sin(2h) = -2·s·c;  cos = -cos(2h) = 2s² - 1
    return -2.0 * s_h * c_h, 2.0 * (s_h * s_h) - 1.0


def sin_cos_small(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) for |x| <= ~1.2 rad (no range reduction; Taylor 9/10)."""
    x2 = x * x
    s = x * (
        1.0
        + x2 * (-1.0 / 6.0 + x2 * (1.0 / 120.0 + x2 * (-1.0 / 5040.0 + x2 * (1.0 / 362880.0))))
    )
    c = 1.0 + x2 * (
        -0.5
        + x2 * (1.0 / 24.0 + x2 * (-1.0 / 720.0 + x2 * (1.0 / 40320.0 + x2 * (-1.0 / 3628800.0))))
    )
    return s, c


def unit_sphere(u1: torch.Tensor, u2: torch.Tensor) -> V3:
    """Uniform direction on S² from two uniforms (``distr.rs:11-21``)."""
    sin1, cos1 = sin_cos_tau(u1)
    s = 2.0 * sqrt_rn(u2 * (1.0 - u2))
    return V3(cos1 * s, sin1 * s, 1.0 - 2.0 * u2)


def unit_hemisphere(normal: V3, u1: torch.Tensor, u2: torch.Tensor) -> V3:
    """Hemisphere fuzz vector about ``normal`` (``distr.rs:49-58``);
    deliberately not normalized."""
    sin1, cos1 = sin_cos_tau(u1)
    s = 2.0 * sqrt_rn(u2 * (1.0 - u2))
    t, b = normal.orthonormal_frame()
    return t * (cos1 * s) + b * (sin1 * s) + normal * (1.0 - u2)


def cosine_hemisphere(normal: V3, u1: torch.Tensor, u2: torch.Tensor) -> V3:
    """Cosine-weighted unit direction about ``normal`` (``distr.rs:87-96``)."""
    sin1, cos1 = sin_cos_tau(u1)
    sq = sqrt_rn(u2)
    t, b = normal.orthonormal_frame()
    return t * (cos1 * sq) + b * (sin1 * sq) + normal * sqrt_rn(1.0 - u2)
