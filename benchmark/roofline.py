"""The benchmark's frozen floor for a render pass's work, and the card's peaks.

A floor is the least time the card could take for the plain algorithm's
work in one pass: the larger of its counted FP32 operations over the
published FP32 peak and its bytes over the published HBM bandwidth. The
operations are those of the plain reference (``benchmark/reference``),
whatever the program's kernel does (a rect is the reference's whole test,
even where a kernel first rejects it more cheaply), and the work counts
(traced segments, RK4 steps, volume events) come from the reference's own
pass over the same pixels, so no change to the program can move the floor.

Operations per event, counted by running the reference's own function on a
batch of lanes (``tests/test_harness_roofline.py`` holds each number to
that count): every add, subtract, multiply, divide, reciprocal, square
root, min, max, floor and clamp bound whose result is per lane counts one;
negations, absolute values, compares, selects, conversions and multiplies
by the constant 1 count none, and neither does arithmetic on a primitive's
or a mass's own values alone (it can be done once for all lanes).

- a segment's intersection: one test of every primitive (the sweep,
  ``intersect.sphere_t``, ``rect_t``, ``box_t``) when the table has at
  most ``LOOP_SWEEP_THRESHOLD`` primitives; above it one test of the
  cheapest kind the scene has, the least any nearest-hit search must do (a
  BVH walk tests at least one primitive);
- a geodesic segment: the capture, far-field and step sweep
  (``geodesic.geo_step_begin``, or ``geo_step_begin_looped`` past
  ``MASS_LOOP_THRESHOLD`` masses), a base plus a share a mass;
- an RK4 step (``geodesic.rk4_step``): the stage states and the sums, and
  4 stages of the acceleration, a share a mass with h² frozen (the looped
  form, ``rk4_step_looped``: a base and a share a mass a stage);
- a volume event: the density lookup (``volume.density_sample``);
- a segment that must scatter: the cheapest scattering shade, metallic
  (``materials.shade_surface`` with that kind alone). At least rays -
  volume events - RK4 steps - paths segments scatter.

Bytes are the tracer's and the fold's own: each lane's id read once, its
three channel sums and ray count written once, the scene's floats and the
camera read once. The accumulate's film traffic is not counted, because
the time the floor is held to is that of the tracer and fold kernels.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores and HBM3, at
# the full power limit of 700 W
PEAK_F32_S = 67e12
PEAK_BYTES_S = 3.35e12

SPHERE_OPS, RECT_OPS, BOX_OPS = 20, 35, 63
SCATTER_OPS = 91
GEO_BEGIN_OPS, GEO_BEGIN_PER_MASS_OPS = 12, 18
LOOPM_BEGIN_OPS, LOOPM_BEGIN_PER_MASS_OPS = 6, 14
RK4_STEP_OPS, ACC_FROZEN_PER_MASS_OPS = 74, 23
ACC_STAGE_OPS, ACC_PER_MASS_OPS = 5, 32
DENSITY_OPS = 45
LOOP_SWEEP_THRESHOLD = 192
MASS_LOOP_THRESHOLD = 8


def segment_ops(n_sph: int, n_rct: int, n_box: int, n_mass: int) -> int:
    """FP32 operations of one traced segment's nearest-hit search (and,
    with masses, its geodesic sweep)."""
    kinds = [(SPHERE_OPS, n_sph), (RECT_OPS, n_rct), (BOX_OPS, n_box)]
    if n_sph + n_rct + n_box > LOOP_SWEEP_THRESHOLD:
        ops = min((o for o, n in kinds if n), default=0)
    else:
        ops = sum(o * n for o, n in kinds)
    if n_mass > MASS_LOOP_THRESHOLD:
        ops += LOOPM_BEGIN_OPS + LOOPM_BEGIN_PER_MASS_OPS * n_mass
    elif n_mass:
        ops += GEO_BEGIN_OPS + GEO_BEGIN_PER_MASS_OPS * n_mass
    return ops


def rk4_ops(n_mass: int) -> int:
    """FP32 operations of one RK4 step."""
    if n_mass > MASS_LOOP_THRESHOLD:
        return RK4_STEP_OPS + 4 * (ACC_STAGE_OPS + ACC_PER_MASS_OPS * n_mass)
    return RK4_STEP_OPS + 4 * ACC_FROZEN_PER_MASS_OPS * n_mass


def pass_ops(scene: dict, rays: float, paths: float, near_steps: float = 0.0,
             vol_events: float = 0.0) -> float:
    """FP32 operations of one pass: ``scene`` holds the primitive and mass
    counts (``n_sph``, ``n_rct``, ``n_box``, ``n_mass``), the rest are the
    pass's work counts."""
    seg = segment_ops(scene["n_sph"], scene["n_rct"], scene["n_box"], scene["n_mass"])
    scatters = max(rays - vol_events - near_steps - paths, 0.0)
    return (rays * seg + near_steps * rk4_ops(scene["n_mass"]) + vol_events * DENSITY_OPS
            + scatters * SCATTER_OPS)


def pass_bytes(scene: dict, lanes: int) -> float:
    """Bytes the tracer and fold must move in one pass: each lane's id read
    once, its three channel sums and ray count written once, the scene's
    floats and the camera read once."""
    return 4.0 * (lanes * (2 + 3 + 1) + scene["floats"] + 32)


def floor_s(scene: dict, rays: float, paths: float, lanes: int, near_steps: float = 0.0,
            vol_events: float = 0.0) -> tuple[float, str]:
    """(least seconds the card could take for the pass, "operations" or
    "bytes")."""
    t_ops = pass_ops(scene, rays, paths, near_steps, vol_events) / PEAK_F32_S
    t_bytes = pass_bytes(scene, lanes) / PEAK_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
