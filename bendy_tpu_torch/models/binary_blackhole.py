"""Binary black-hole showcase: two superposed Schwarzschild masses.

Demonstrates multi-mass geodesic superposition (``bendy_tpu_torch.geodesic``):
a pair of shadows, peripheral star arcs, and doubly-imaged stars between
the holes. Rendered reference: docs/binary_blackhole_512.png.

A copy of ``bendy_tpu/models/binary_blackhole.py`` with its imports pointed at
``bendy_tpu_torch.scene.graph`` (the reference's cannot be imported
without jax); ``dumps_scene`` of either build is byte-equal.
"""

from __future__ import annotations

import numpy as np

from bendy_tpu_torch.scene.graph import (
    Camera,
    Data,
    Material,
    Object,
    ObjectFlags,
    Scene,
    Sphere,
)

_STAR_COLORS = [
    ((1.0, 0.8, 0.5), 2.0),
    ((0.6, 0.8, 1.0), 1.8),
    ((1.0, 0.5, 0.4), 1.6),
    ((0.8, 1.0, 0.7), 1.6),
    ((1.0, 0.95, 0.8), 2.2),
]


def build_binary_blackhole(rs: float = 0.7, seed: int = 4) -> Scene:
    scene = Scene()
    env = scene.add_data(Data(Material.emissive((0.25, 0.3, 0.45), 0.05)))
    scene.set_root_material(env)

    scene.add_object(Object().with_tag(f"mass:{rs}").with_translation([-2.4, 0, 0]))
    scene.add_object(Object().with_tag(f"mass:{rs}").with_translation([2.4, 0.5, -1.0]))
    scene.add_object(
        Object(Camera(focus=None)).with_tag("camera").with_translation([0, 0.8, 24.0])
    )

    # starfield grid behind the pair: dense enough that lensing arcs show
    rng = np.random.default_rng(seed)
    k = 0
    for gy in range(-4, 5, 2):
        for gx in range(-5, 6, 2):
            albedo, intensity = _STAR_COLORS[k % len(_STAR_COLORS)]
            mat = scene.add_data(Data(Material.emissive(albedo, intensity)))
            pos = (
                gx * 2.2 + rng.uniform(-0.7, 0.7),
                gy * 2.2 + rng.uniform(-0.7, 0.7),
                -30.0 - rng.uniform(0, 8),
            )
            scene.add_object(
                Object(Sphere(material=mat, radius=0.8)).with_translation(pos).with_flags(
                    ObjectFlags.LIGHT
                )
            )
            k += 1
    return scene
