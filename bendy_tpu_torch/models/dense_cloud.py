"""Dense 32³ volumetric cloud: the dense-grid stress scene.

Every cell of the 32³ density grid is nonzero (32,768 cells — a smooth
radial blob over a thin ambient haze), the workload class the reference
samples exactly like any other grid (uniform ``DensityMap::sample``,
``src/scene/data/volume.rs:140-166``). The TPU kernel needs a second
lookup form for it (a one-hot brick fetch on the MXU); the port's CUDA
kernel reads it with the same 8-corner gather as a sparse grid.

A copy of ``bendy_tpu/models/dense_cloud.py`` with its imports pointed at
``bendy_tpu_torch.scene.graph`` (the reference's cannot be imported
without jax); ``dumps_scene`` of either build is byte-equal. The bundled
``scenes/dense_cloud.json.gz`` is that build.
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


def blob_density(n: int = 32):
    """Smooth radial blob over an ambient floor — ALL cells nonzero."""

    def f(x: int, y: int, z: int) -> float:
        px = (x + 0.5) / n * 2.0 - 1.0
        py = (y + 0.5) / n * 2.0 - 1.0
        pz = (z + 0.5) / n * 2.0 - 1.0
        r2 = px * px + py * py + pz * pz
        # two off-center lobes + haze: structure at scales the grid resolves
        l1 = 2.4 * math.exp(-(((px - 0.25) ** 2 + py * py + pz * pz) / 0.18))
        l2 = 1.6 * math.exp(-(((px + 0.35) ** 2 + (py - 0.2) ** 2 + pz * pz) / 0.10))
        return 0.06 * math.exp(-r2) + l1 + l2

    return DensityMap.with_func(n, n, n, f)


def build_dense_cloud() -> Scene:
    """Camera + dense-volume sphere + two emissive star lights.

    Mirrors the bundled cloud scene's layout (camera at +z, lit volume
    sphere at the origin) with the 16³ sparse grid swapped for a dense
    32³ one.
    """
    scene = Scene()

    env = scene.add_data(Data(Material.emissive((0.5, 0.6, 0.8), 0.1)))
    scene.set_root_material(env)

    scene.add_object(
        Object(Camera(focal_length=0.06, sensor_size=0.024, focus=None))
        .with_tag("camera")
        .with_translation([0.0, 0.4, 6.0])
    )

    vol = scene.add_data(Data(blob_density()))
    shell = scene.add_data(Data(Material.flat((1.0, 1.0, 1.0))))
    scene.add_object(
        Object(Sphere(material=shell, radius=1.4, volume=vol)).with_tag("cloud")
    )

    for pos, albedo, inten, r in [
        ((3.2, 2.6, 1.5), (1.0, 0.9, 0.75), 9.0, 0.8),
        ((-2.8, -1.2, 2.2), (0.75, 0.82, 1.0), 5.0, 0.6),
    ]:
        mat = scene.add_data(Data(Material.emissive(albedo, inten)))
        scene.add_object(
            Object(Sphere(material=mat, radius=r))
            .with_translation(pos)
            .with_flags(ObjectFlags.LIGHT)
        )
    return scene

