"""Cluster lensing: tens-to-hundreds of point masses in one scene.

A compact cluster of 64 Schwarzschild masses (each an Empty tagged
``mass:<rs>``, so the file still round-trips the reference-compatible
schema) lensing a far grid of emissive "galaxies" into arcs. Past
``render.MASS_LOOP_THRESHOLD`` masses the tracer takes the looped mass
sweep (``geodesic.geo_step_begin_looped`` / ``rk4_step_looped``, the
kernel's LOOPM instantiation), whose RK4 recomputes h² per stage.
Materials stay emissive/flat: the per-iteration cost is the mass sweep
itself.

A copy of ``bendy_tpu/models/mass_cluster.py`` with its imports pointed
at ``bendy_tpu_torch.scene.graph``; ``dumps_scene`` of either build is
byte-equal. The bundled ``scenes/mass_cluster.json.gz`` is that build.
"""

from __future__ import annotations

import math
import random

from bendy_tpu_torch.scene.graph import (
    Camera,
    Data,
    Material,
    Object,
    Scene,
    Sphere,
)


def build_mass_cluster(n_masses: int = 64, seed: int = 23) -> Scene:
    """``n_masses`` point masses in a ball, lensing a far galaxy grid.

    The cluster sits between the camera (z = +26) and a 9x7 grid of
    small emissive spheres at z = -36; rays thread the cluster, so the
    adaptive step (eta x distance-to-nearest-mass) stays genuinely
    multi-mass — no single mass dominates the step or the far-field
    test.
    """
    rng = random.Random(seed)
    scene = Scene()

    env = scene.add_data(Data(Material.emissive((0.12, 0.13, 0.18), 0.03)))
    scene.set_root_material(env)

    scene.add_object(
        Object(Camera(focal_length=0.06, sensor_size=0.024, focus=None))
        .with_tag("camera")
        .with_translation([0.0, 0.0, 26.0])
    )

    # the cluster: masses in a ~3-unit ball, mildly flattened like a
    # galaxy cluster's potential; rs spans 4x so capture shadows vary
    for _ in range(n_masses):
        while True:
            x, y, z = (rng.uniform(-1.0, 1.0) for _ in range(3))
            if x * x + y * y + z * z <= 1.0:
                break
        pos = [3.2 * x, 2.2 * y, 2.6 * z]
        rs = rng.uniform(0.04, 0.16)
        scene.add_object(Object().with_tag(f"mass:{rs:.4f}").with_translation(pos))

    # far galaxy grid: small bright spheres the cluster shears into arcs
    cols = [
        ((1.0, 0.85, 0.6), 2.2),
        ((0.6, 0.78, 1.0), 2.0),
        ((1.0, 0.6, 0.5), 1.8),
        ((0.75, 1.0, 0.7), 1.6),
    ]
    i = 0
    for gy in range(7):
        for gx in range(9):
            px = (gx - 4) * 3.4 + rng.uniform(-0.5, 0.5)
            py = (gy - 3) * 3.4 + rng.uniform(-0.5, 0.5)
            albedo, inten = cols[i % len(cols)]
            i += 1
            mat = scene.add_data(Data(Material.emissive(albedo, inten)))
            scene.add_object(
                Object(Sphere(material=mat, radius=0.65 + 0.25 * math.sin(i)))
                .with_translation([px, py, -36.0])
            )
    return scene

