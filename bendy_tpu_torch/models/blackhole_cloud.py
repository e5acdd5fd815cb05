"""Volumetric accretion-disk black hole: the geodesic × volume showcase.

A Schwarzschild mass whose equatorial plane carries a *participating
medium* disk — a 16³ density grid (torus band, thin in y) inside a
volume sphere — lit by close emissive stars. Exercises the full product
of the two hardest integrator modes at once: RK4 chord stepping outside
the cloud, probabilistic volume marching (``volume.rs:26-67`` semantics)
inside it, capture at the horizon, and lensed star images behind.

Render with a march step that keeps the 12-unit crossing under the
32-volume-bounce cap, as the reference's benchmark row does:
``Config(max_bounces=2, volume_step=0.6)``.

A copy of ``bendy_tpu/models/blackhole_cloud.py`` with its imports pointed
at ``bendy_tpu_torch.scene.graph`` (the reference's cannot be imported
without jax); ``dumps_scene`` of either build is byte-equal. The bundled
``scenes/blackhole_cloud.json.gz`` is that build.
"""

from __future__ import annotations

import math

from bendy_tpu_torch.scene.graph import (
    Camera,
    Data,
    DensityMap,
    Material,
    Object,
    ObjectFlags,
    Scene,
    Sphere,
)

DISK_RADIUS = 6.0  # world half-extent of the volume sphere.
# NOTE the reference's volume-bounce cap (32, ``tracer/mod.rs:352-354``)
# kills any path marching more steps: crossing this sphere takes
# diameter/volume_step marches, so render the scene with
# Config(volume_step >= 0.5) — scatter probability is step-scaled
# (``volume.rs:36``), so the estimator stays consistent.


def disk_density(rs: float, n: int = 16):
    """Torus-band density: hot ring between ~3rs and ~7rs, thin in y."""

    def f(x: int, y: int, z: int) -> float:
        # cell center in [-1, 1]^3 of the carrier sphere's bbox
        px = (x + 0.5) / n * 2.0 - 1.0
        py = (y + 0.5) / n * 2.0 - 1.0
        pz = (z + 0.5) / n * 2.0 - 1.0
        r = math.hypot(px, pz) * DISK_RADIUS
        band = math.exp(-(((r - 4.0 * rs) / (1.2 * rs)) ** 2))
        thin = math.exp(-((py * DISK_RADIUS / 0.8) ** 2))
        d = 3.0 * band * thin
        return d if d > 0.05 else 0.0  # keep the grid sparse

    return DensityMap.with_func(n, n, n, f)


def build_blackhole_cloud(rs: float = 1.0) -> Scene:
    scene = Scene()

    env = scene.add_data(Data(Material.emissive((0.25, 0.28, 0.38), 0.015)))
    scene.set_root_material(env)

    scene.add_object(Object().with_tag(f"mass:{rs}"))
    scene.add_object(
        Object(Camera(focal_length=0.05, sensor_size=0.024, focus=None))
        .with_tag("camera")
        .with_translation([0.0, 2.2, 21.0])
    )

    # the volumetric disk: a density grid carried by a sphere around the mass
    vol = scene.add_data(Data(disk_density(rs)))
    shell = scene.add_data(Data(Material.flat((1.0, 1.0, 1.0))))
    scene.add_object(
        Object(Sphere(material=shell, radius=DISK_RADIUS, volume=vol))
        .with_tag("disk")
    )

    # hot stars close above/below the plane light the scattering disk
    for pos, albedo, inten, r in [
        ((5.5, 4.0, 2.0), (1.0, 0.82, 0.55), 7.0, 1.1),
        ((-6.0, -3.5, -1.0), (0.8, 0.85, 1.0), 5.0, 0.9),
        # almost exactly behind the hole: the lensed Einstein-ring source
        ((0.4, 0.3, -40.0), (1.0, 0.7, 0.4), 2.2, 1.4),
    ]:
        mat = scene.add_data(Data(Material.emissive(albedo, inten)))
        scene.add_object(
            Object(Sphere(material=mat, radius=r)).with_translation(pos).with_flags(
                ObjectFlags.LIGHT
            )
        )

    # scene-tuned geodesic block (schema-compatible: serde ignores it)
    scene.geodesic = {"eta": 0.15, "max_steps": 384}
    return scene

