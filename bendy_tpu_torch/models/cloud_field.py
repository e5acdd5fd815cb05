"""Cloud field: hundreds of small volume-sphere puffs in one scene.

258 spheres (256 puffs and two sun lights) put it past
``render.LOOP_SWEEP_THRESHOLD``, so the reference traces it with its
looped table sweep and media; the port's volume kernel sweeps the same
rows with its run-time loop. All puffs share ONE sparse density grid
(the compiler stacks grids; a shared Data keeps the stack at a single
12³ level) and a flat white shell, like the bundled cloud scene.

A copy of ``bendy_tpu/models/cloud_field.py`` with its imports pointed
at ``bendy_tpu_torch.scene.graph``; ``dumps_scene`` of either build is
byte-equal. The bundled ``scenes/cloud_field.json.gz`` is that build.
"""

from __future__ import annotations

import math
import random

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


def puff_density(n: int = 12):
    """Compact radial puff: nonzero only inside ~80% radius (sparse)."""

    def f(x: int, y: int, z: int) -> float:
        px = (x + 0.5) / n * 2.0 - 1.0
        py = (y + 0.5) / n * 2.0 - 1.0
        pz = (z + 0.5) / n * 2.0 - 1.0
        r2 = px * px + py * py + pz * pz
        if r2 > 0.64:
            return 0.0
        return 2.0 * math.exp(-3.0 * r2)

    return DensityMap.with_func(n, n, n, f)


def build_cloud_field(n_puffs: int = 256, seed: int = 19) -> Scene:
    """``n_puffs`` volume spheres in a wavy sheet + two emissive suns.

    Camera looks across the sheet from above so near puffs fill the
    frame and far ones recede — march lanes and surface lanes mix.
    """
    rng = random.Random(seed)
    scene = Scene()

    env = scene.add_data(Data(Material.emissive((0.45, 0.6, 0.85), 0.25)))
    scene.set_root_material(env)

    side = max(1, math.ceil(math.sqrt(n_puffs)))
    pitch = 1.6
    extent = side * pitch / 2.0

    from bendy_tpu_torch.scene.graph import affine_from_rotation_translation, quat_from_euler_yxz

    scene.add_object(
        Object(Camera(focal_length=0.05, sensor_size=0.024, focus=None))
        .with_tag("camera")
        .with_transform(
            affine_from_rotation_translation(
                quat_from_euler_yxz(0.0, -0.3, 0.0),
                [0.0, extent * 0.5 + 1.5, extent * 1.7 + 3.0],
            )
        )
    )

    vol = scene.add_data(Data(puff_density()))
    shell = scene.add_data(Data(Material.flat((1.0, 1.0, 1.0))))
    count = 0
    for gz in range(side):
        for gx in range(side):
            if count >= n_puffs:
                break
            x = (gx + 0.5) * pitch - extent + rng.uniform(-0.25, 0.25)
            z = (gz + 0.5) * pitch - extent + rng.uniform(-0.25, 0.25)
            # wavy sheet: nearby puffs overlap into banks
            y = 1.2 * math.sin(0.7 * x) * math.cos(0.5 * z) + rng.uniform(-0.3, 0.3)
            r = rng.uniform(0.55, 0.95)
            scene.add_object(
                Object(Sphere(material=shell, radius=r, volume=vol))
                .with_translation([x, y, z])
            )
            count += 1

    for pos, albedo, inten, r in [
        ((extent * 0.8, extent * 0.9 + 4.0, extent * 0.5), (1.0, 0.92, 0.8), 12.0, 2.0),
        ((-extent * 0.9, extent * 0.5 + 3.0, -extent * 0.4), (0.8, 0.85, 1.0), 6.0, 1.4),
    ]:
        mat = scene.add_data(Data(Material.emissive(albedo, inten)))
        scene.add_object(
            Object(Sphere(material=mat, radius=r))
            .with_translation(list(pos))
            .with_flags(ObjectFlags.LIGHT)
        )
    return scene

