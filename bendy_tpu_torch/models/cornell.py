"""Built-in Cornell box, matching the reference app's default scene
construction (``src/main.rs:108-214``) object for object.

A copy of ``bendy_tpu/models/cornell.py`` with its imports pointed at
``bendy_tpu_torch.scene.graph`` (the reference's cannot be imported
without jax); ``dumps_scene`` of either build is byte-equal.
"""

from __future__ import annotations

import numpy as np

from bendy_tpu_torch.scene.graph import (
    Camera,
    Cuboid,
    Data,
    Material,
    Object,
    ObjectFlags,
    Rect,
    Scene,
    affine_from_rotation_translation,
    quat_from_euler_yxz,
)


def build_cornell() -> Scene:
    scene = Scene()

    mat_light = scene.add_data(Data(Material.emissive((1.0, 1.0, 1.0), 20.0)))
    mat_white = scene.add_data(Data(Material.diffuse((0.73, 0.73, 0.73), 1.0)))
    mat_metal = scene.add_data(Data(Material.metallic((0.55, 0.55, 0.55), 0.01)))
    mat_red = scene.add_data(Data(Material.diffuse((0.7, 0.1, 0.1), 0.5)))
    mat_green = scene.add_data(Data(Material.diffuse((0.2, 0.7, 0.4), 0.8)))

    scene.add_object(
        Object(Camera(focal_length=0.05, fstop=1.4, focus=12.5))
        .with_tag("camera")
        .with_translation([0.0, 2.5, 10.0])
    )
    # left / right / back / floor / ceiling (``main.rs:132-176``)
    scene.add_object(
        Object(Rect.from_edges(mat_green, [0, 0, -2.5], [0, 2.5, 0]))
        .with_translation([-2.5, 2.5, -2.5])
    )
    scene.add_object(
        Object(Rect.from_edges(mat_red, [0, 0, 2.5], [0, 2.5, 0]))
        .with_translation([2.5, 2.5, -2.5])
    )
    scene.add_object(
        Object(Rect.from_edges(mat_white, [2.5, 0, 0], [0, 2.5, 0]))
        .with_translation([0.0, 2.5, -5.0])
    )
    scene.add_object(
        Object(Rect.from_edges(mat_white, [2.5, 0, 0], [0, 0, -2.5]))
        .with_translation([0.0, 0.0, -2.5])
    )
    scene.add_object(
        Object(Rect.from_edges(mat_white, [2.5, 0, 0], [0, 0, 2.5]))
        .with_translation([0.0, 5.0, -2.5])
    )
    scene.add_object(
        Object(Rect.from_edges(mat_light, [0.5, 0, 0], [0, 0, 0.5]))
        .with_translation([0.0, 4.999, -2.5])
        .with_flags(ObjectFlags.LIGHT)
    )
    # tall metal box, rotated 20 deg about Y (``main.rs:188-199``)
    angle = np.deg2rad(20.0)
    scene.add_object(
        Object(Cuboid.from_axes(mat_metal, [0.5, 0, 0], [0, 1.0, 0], [0, 0, 0.4]))
        .with_transform(
            affine_from_rotation_translation(
                quat_from_euler_yxz(angle, 0.0, 0.0), [-1.2, 1.0, -3.2]
            )
        )
    )
    # short white box (``main.rs:202-210``)
    scene.add_object(
        Object(Cuboid.from_axes(mat_white, [0.5, 0, 0], [0, 0.6, 0], [0, 0, 0.5]))
        .with_translation([1.0, 0.6, -1.4])
    )
    return scene
