"""Null-geodesic ray propagation around point masses (counterpart of
``bendy_tpu/geodesic.py``).

Photons around a Schwarzschild mass follow the effective acceleration

    a(x, d) = -(3/2) · rs · h² · x / |x|⁵,   h = |x × d|

superposed over the scene's masses (objects tagged ``mass:<rs>``), and are
integrated by classical RK4 with an adaptive step
ds = clip(eta·(1 + growth·k)·r_min, min_step, max_step). A lane is
captured when r < rs for any mass, and is in flat space (``far``) when
r > far·rs for every mass and it recedes from all of them.

These are plain functions on V3-of-[B] tensors, in the reference's
operation order (1/sqrt, not ``torch.rsqrt``; ``inv_r⁵`` as four
multiplies; the RK4 sums as ``_rk4`` writes them), so the CUDA tracer's
geodesic instantiation (``csrc/trace_surface.cu``), built without
contraction, rounds as they do. The wavefront integrator's geodesic mode
(:func:`bendy_tpu_torch.ops.wavefront.trace_core`) uses them for the
unrolled mass sweep of up to ``render.MASS_LOOP_THRESHOLD`` masses, where
the step freezes the per-mass h² (:func:`geo_step_begin`,
:func:`rk4_step` with ``h2s``).

Above the threshold (``TraceConfig.looped_masses``: ``mass_cluster``'s 64
masses) it takes the looped mass sweep, the plain version of the kernel's
LOOPM instantiation (the reference's kernel 1e-iii):
:func:`geo_step_begin_looped` returns no h², and :func:`rk4_step_looped`
recomputes h² at every RK4 stage from that stage's state. That is another
discretization of the same ODE, so the threshold changes the image at
rounding level, as in the reference.

Geodesics inside media (``blackhole_cloud``) use the same functions:
marching lanes step straight and only the capture test applies to them
(:func:`bendy_tpu_torch.ops.wavefront.trace_core`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .compiler import SceneArrays
from .v3 import V3, sqrt_rn


class GeoParams(NamedTuple):
    """Static geodesic integration knobs (defaults as ``bendy_tpu``)."""

    eta: float = 0.2  # step = eta · distance-to-nearest-mass
    min_step: float = 0.02  # in scene units
    max_step: float = 30.0
    far: float = 80.0  # flat-space radius (in units of rs) per mass
    max_steps: int = 256  # RK4 step budget per path before capture
    growth: float = 0.02  # progressive step coarsening: eta·(1 + growth·k)


def geo_from_dict(d: dict | None) -> GeoParams:
    """GeoParams from a scene file's optional ``"geodesic"`` block."""
    if not d:
        return GeoParams()
    bad = sorted(set(d) - set(GeoParams._fields))
    if bad:
        raise ValueError(
            f"unknown geodesic parameter(s) {bad}; valid: {list(GeoParams._fields)}"
        )
    conv = {k: (int(v) if k == "max_steps" else float(v)) for k, v in d.items()}
    return GeoParams()._replace(**conv)


def mass_row(scn: SceneArrays, k: int) -> tuple[V3, torch.Tensor]:
    c = scn.mass_center
    return V3(c[k, 0], c[k, 1], c[k, 2]), scn.mass_rs[k]


def _inv_r5(r2: torch.Tensor) -> torch.Tensor:
    """|x|⁻⁵ from r², 0 at the mass itself (four multiplies, left to right)."""
    inv_r = torch.where(r2 > 0.0, 1.0 / sqrt_rn(torch.clamp_min(r2, 1e-20)), 0.0)
    return inv_r * inv_r * inv_r * inv_r * inv_r


def acceleration(scn: SceneArrays, x: V3, d: V3) -> V3:
    """Sum of per-mass geodesic accelerations, h² from the stage state."""
    a = V3.zeros(x.x.shape, x.x.device)
    for k in range(scn.n_masses):
        center, rs = mass_row(scn, k)
        rel = x - center
        h2 = rel.cross(d).length_squared()
        a = a + rel * (-1.5 * rs * h2 * _inv_r5(rel.length_squared()))
    return a


def _eta(p: GeoParams, steps) -> float | torch.Tensor:
    """eta·(1 + growth·steps): progressive coarsening of long paths."""
    if steps is not None and p.growth:
        return p.eta * (1.0 + p.growth * steps.to(torch.get_default_dtype()))
    return p.eta


def step_size(scn: SceneArrays, x: V3, p: GeoParams, steps=None) -> torch.Tensor:
    """Adaptive ds: a fraction of the distance to the nearest mass."""
    r2_min = torch.full(x.x.shape, torch.inf, device=x.x.device)
    for k in range(scn.n_masses):
        center, _ = mass_row(scn, k)
        r2_min = torch.minimum(r2_min, (x - center).length_squared())
    return torch.clamp(_eta(p, steps) * sqrt_rn(r2_min), p.min_step, p.max_step)


def _acc_frozen(scn: SceneArrays, x: V3, h2s: list) -> V3:
    """Acceleration with per-mass h² frozen at the step start (h is
    conserved along the exact trajectory, so every RK4 stage may reuse
    it; local error stays O(ds⁵))."""
    a = V3.zeros(x.x.shape, x.x.device)
    for k in range(scn.n_masses):
        center, rs = mass_row(scn, k)
        rel = x - center
        a = a + rel * (-1.5 * rs * h2s[k] * _inv_r5(rel.length_squared()))
    return a


def geo_step_begin(scn: SceneArrays, x: V3, d: V3, p: GeoParams, steps=None):
    """Fused once-per-iteration mass sweep: (captured, far, ds, h2s).

    h² uses the Lagrange identity |rel×d|² = r²·|d|² − (rel·d)², reusing r²
    and the receding test's rel·d.
    """
    B = x.x.shape
    dev = x.x.device
    captured = torch.zeros(B, dtype=torch.bool, device=dev)
    far = torch.ones(B, dtype=torch.bool, device=dev)
    r2_min = torch.full(B, torch.inf, device=dev)
    d2 = d.length_squared()
    h2s = []
    for k in range(scn.n_masses):
        center, rs = mass_row(scn, k)
        rel = x - center
        r2 = rel.length_squared()
        rd = rel.dot(d)
        far_r = p.far * rs
        captured = captured | (r2 < rs * rs)
        far = far & ((r2 > far_r * far_r) & (rd > 0.0))
        r2_min = torch.minimum(r2_min, r2)
        h2s.append(torch.clamp_min(r2 * d2 - rd * rd, 0.0))
    ds = torch.clamp(_eta(p, steps) * sqrt_rn(r2_min), p.min_step, p.max_step)
    return captured, far, ds, h2s


def rk4_step(scn: SceneArrays, x: V3, d: V3, ds: torch.Tensor,
             h2s: list | None = None) -> tuple[V3, V3]:
    """One RK4 step of dx/dλ = d, dd/dλ = a(x, d): with ``h2s`` (from
    :func:`geo_step_begin`) the per-mass h² stay frozen for the step,
    without it they are recomputed per stage."""
    if h2s is None:
        def acc(xs, dstage):
            return acceleration(scn, xs, dstage)
    else:
        def acc(xs, dstage):
            return _acc_frozen(scn, xs, h2s)
    return _rk4(acc, x, d, ds)


def _mass_terms(scn: SceneArrays, x: V3):
    """(rel [M,B] V3, rs [M,1]) of every mass row against every lane."""
    c = scn.mass_center[:, :, None]
    rel = V3(x.x[None] - c[:, 0], x.y[None] - c[:, 1], x.z[None] - c[:, 2])
    return rel, scn.mass_rs[:, None]


def geo_step_begin_looped(scn: SceneArrays, x: V3, d: V3, p: GeoParams, steps=None):
    """Looped-mass twin of :func:`geo_step_begin`: ``(captured, far, ds)``,
    and no h² (counterpart of ``bendy_tpu.geodesic.geo_step_begin_looped``).

    The reference pads its mass table to ``MASS_BLOCK`` rows with rs = 0,
    valid = 0, and masks pad rows out of ``far`` and the r² min; over the
    ``n_masses`` real rows alone the function is the same, so there is no
    mass table here. The per-mass terms are [M, B] tensors (elementwise, so
    each rounds as a per-mass op would); capture, far field and the min
    are order-free.
    """
    rel, rs = _mass_terms(scn, x)
    r2 = rel.length_squared()
    rd = rel.dot(V3(d.x[None], d.y[None], d.z[None]))
    far_r = p.far * rs
    captured = (r2 < rs * rs).any(dim=0)
    far = ((r2 > far_r * far_r) & (rd > 0.0)).all(dim=0)
    r2_min = r2.amin(dim=0) if scn.n_masses else torch.full_like(x.x, torch.inf)
    ds = torch.clamp(_eta(p, steps) * sqrt_rn(r2_min), p.min_step, p.max_step)
    return captured, far, ds


def _acc_looped(scn: SceneArrays, x: V3, d: V3) -> V3:
    """Acceleration with h² recomputed from the stage state by the Lagrange
    identity max(r²·|d|² − (rel·d)², 0), as the reference's looped sweep
    writes it: s = (−1.5·rs)·(h²·inv_r⁵) (another association than
    :func:`_acc_frozen`'s), summed one mass at a time in row order (a
    reduction over M would reassociate the sum and lose bit-equality with
    the kernel)."""
    rel, rs = _mass_terms(scn, x)
    r2 = rel.length_squared()
    d2 = d.length_squared()
    rd = rel.dot(V3(d.x[None], d.y[None], d.z[None]))
    h2 = torch.clamp_min(r2 * d2[None] - rd * rd, 0.0)
    s = (-1.5 * rs) * (h2 * _inv_r5(r2))
    ax, ay, az = rel.x * s, rel.y * s, rel.z * s
    a = V3.zeros(x.x.shape, x.x.device)
    for k in range(scn.n_masses):
        a = V3(a.x + ax[k], a.y + ay[k], a.z + az[k])
    return a


def rk4_step_looped(scn: SceneArrays, x: V3, d: V3, ds: torch.Tensor) -> tuple[V3, V3]:
    """Looped-mass RK4 step: per-mass h² recomputed per stage
    (:func:`_acc_looped`; counterpart of ``bendy_tpu.geodesic.rk4_step_looped``)."""
    return _rk4(lambda xs, dstage: _acc_looped(scn, xs, dstage), x, d, ds)


def _rk4(acc, x: V3, d: V3, ds: torch.Tensor) -> tuple[V3, V3]:
    """The four-stage RK4 body (one ``acc(x, d)`` callable)."""
    half = ds * 0.5
    k1x, k1d = d, acc(x, d)
    k2x = d + k1d * half
    k2d = acc(x + k1x * half, k2x)
    k3x = d + k2d * half
    k3d = acc(x + k2x * half, k3x)
    k4x = d + k3d * ds
    k4d = acc(x + k3x * ds, k4x)
    sixth = ds * (1.0 / 6.0)
    x_new = x + (k1x + (k2x + k3x) * 2.0 + k4x) * sixth
    d_new = d + (k1d + (k2d + k3d) * 2.0 + k4d) * sixth
    return x_new, d_new


def capture_and_far(scn: SceneArrays, x: V3, d: V3, p: GeoParams):
    """(captured, far_field): horizon capture and flat-space tests."""
    captured, far, _, _ = geo_step_begin(scn, x, d, p)
    return captured, far
