"""Geodesic integration knobs (counterpart of ``bendy_tpu/geodesic.py``).

Only the parameter block is here: scene files carry an optional
``"geodesic"`` block that :mod:`bendy_tpu_torch.scene.io` validates at load
time, and :class:`bendy_tpu_torch.render.Config` holds a ``geo`` field. The
propagator itself (RK4 chord stepping, capture, far field) is not ported
yet; :func:`bendy_tpu_torch.ops.wavefront.trace_core` refuses geodesic
scenes.
"""

from __future__ import annotations

from typing import NamedTuple


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
