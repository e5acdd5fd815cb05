"""Primitive-count scaling scenes: an n-primitive field of spheres/boxes,
and the light-count and cuboid-light scenes beside it.

Layout: alternating spheres and rotated cuboids on a ground rect, one
overhead rect light, deterministic placement/material mix from a seeded
RNG. ``build_prim_grid(n)`` yields n field primitives + ground + light
+ camera; past ``render.LOOP_SWEEP_THRESHOLD`` primitives (n > 190) the
reference sweeps them with its looped table sweep, which the port's
kernel computes with the same run-time loop as any other scene.

A copy of ``bendy_tpu/models/prim_grid.py`` with its imports pointed at
``bendy_tpu_torch.scene.graph`` (the reference's cannot be imported
without jax); ``dumps_scene`` of either build is byte-equal.
"""

from __future__ import annotations

import math
import random

from bendy_tpu_torch.scene.graph import (
    Camera,
    Cuboid,
    Data,
    Material,
    Object,
    ObjectFlags,
    Rect,
    Scene,
    Sphere,
    affine_from_rotation_translation,
    quat_from_euler_yxz,
)


def build_light_field(n_lights: int, seed: int = 11) -> Scene:
    """A scene with ``n_lights`` LIGHT-flagged emitters (alternating
    spheres and rects) over a diffuse ground — the light-count twin of
    :func:`build_prim_grid`. The reference supports any light count at
    zero compile cost (it picks one uniformly per shade,
    ``material.rs:106-122``); past ``render.LIGHT_LOOP_THRESHOLD``
    lights the reference sweeps them with a loop (``looped_lights``)."""
    rng = random.Random(seed)
    scene = Scene()
    env = scene.add_data(Data(Material.flat((0.0, 0.0, 0.0))))
    scene.set_root_material(env)

    side = max(1, math.ceil(math.sqrt(n_lights)))
    pitch = 2.5
    extent = side * pitch / 2.0
    cam_pos = [0.0, extent * 0.9 + 2.0, extent * 2.2 + 4.0]
    scene.add_object(
        Object(Camera(focal_length=0.05, sensor_size=0.024, focus=None))
        .with_tag("camera")
        .with_transform(
            affine_from_rotation_translation(
                quat_from_euler_yxz(0.0, -0.35, 0.0), cam_pos
            )
        )
    )
    ground = scene.add_data(Data(Material.diffuse((0.6, 0.58, 0.55), 0.8)))
    scene.add_object(
        Object(Rect.from_edges(ground, [extent * 4, 0, 0], [0, 0, -extent * 4]))
        .with_translation([0.0, 0.0, 0.0])
    )
    count = 0
    for gz in range(side):
        for gx in range(side):
            if count >= n_lights:
                break
            x = (gx + 0.5) * pitch - extent
            z = (gz + 0.5) * pitch - extent
            tint = (1.0, rng.uniform(0.5, 1.0), rng.uniform(0.3, 1.0))
            mat = scene.add_data(Data(Material.emissive(tint, rng.uniform(4.0, 9.0))))
            if (gx + gz) % 2 == 0:
                scene.add_object(
                    Object(Sphere(material=mat, radius=0.35))
                    .with_translation([x, rng.uniform(1.0, 2.2), z])
                    .with_flags(ObjectFlags.LIGHT)
                )
            else:
                scene.add_object(
                    Object(Rect.from_edges(mat, [0.4, 0, 0], [0, 0, -0.4]))
                    .with_translation([x, rng.uniform(1.0, 2.2), z])
                    .with_flags(ObjectFlags.LIGHT)
                )
            count += 1
    return scene


def build_cuboid_light(seed: int = 13) -> Scene:
    """A LIGHT-flagged emissive cuboid over a diffuse floor, plus a small
    rect light: the only scene exercising the F>1 area-weighted face CDF
    of ``sample_light_point``/``light_pdf`` (and its looped twins)
    end-to-end (``src/scene/object/cuboid.rs:48-81``: pick a face by
    area, pdf from the nearest face along the shadow ray).

    Design notes for a tight oracle gate: the cuboid's axes are unequal
    (0.9/0.35/0.55) so the six face areas differ and the CDF is
    non-uniform; it is rotated so several faces are visible from both
    the camera and the floor; the env is black so ALL radiance routes
    through the two lights; the rect light makes L=2 with one valid face
    (the lval padding mask of the [L, F] table is live, not degenerate).
    """
    rng = random.Random(seed)
    scene = Scene()
    env = scene.add_data(Data(Material.flat((0.0, 0.0, 0.0))))
    scene.set_root_material(env)

    scene.add_object(
        Object(Camera(focal_length=0.05, sensor_size=0.024, focus=None))
        .with_tag("camera")
        .with_transform(
            affine_from_rotation_translation(
                quat_from_euler_yxz(0.0, -0.3, 0.0), [0.0, 3.2, 9.0]
            )
        )
    )
    ground = scene.add_data(Data(Material.diffuse((0.62, 0.58, 0.55), 0.8)))
    scene.add_object(
        Object(Rect.from_edges(ground, [8.0, 0, 0], [0, 0, -8.0]))
        .with_translation([0.0, 0.0, 0.0])
    )
    back = scene.add_data(Data(Material.diffuse((0.5, 0.55, 0.65), 0.8)))
    scene.add_object(
        Object(Rect.from_edges(back, [8.0, 0, 0], [0, 4.0, 0]))
        .with_translation([0.0, 4.0, -8.0])
    )

    glow = scene.add_data(Data(Material.emissive((1.0, 0.9, 0.75), 7.0)))
    scene.add_object(
        Object(Cuboid.from_axes(glow, [0.9, 0, 0], [0, 0.35, 0], [0, 0, 0.55]))
        .with_transform(
            affine_from_rotation_translation(
                quat_from_euler_yxz(0.7, 0.3, 0.2), [-0.8, 2.4, -1.0]
            )
        )
        .with_flags(ObjectFlags.LIGHT)
    )
    spark = scene.add_data(Data(Material.emissive((0.6, 0.8, 1.0), 9.0)))
    scene.add_object(
        Object(Rect.from_edges(spark, [0.35, 0, 0], [0, 0, -0.35]))
        .with_translation([2.6, 3.4, 0.5])
        .with_flags(ObjectFlags.LIGHT)
    )

    # diffuse receivers: NEE toward the cuboid dominates their radiance
    matl = [
        scene.add_data(Data(Material.diffuse((0.75, 0.4, 0.35), 0.75))),
        scene.add_data(Data(Material.diffuse((0.35, 0.65, 0.5), 0.75))),
    ]
    for i in range(4):
        x = -2.5 + 1.7 * i + rng.uniform(-0.2, 0.2)
        r = rng.uniform(0.35, 0.6)
        scene.add_object(
            Object(Sphere(material=matl[i % 2], radius=r))
            .with_translation([x, r, rng.uniform(0.0, 1.5)])
        )
    return scene


def build_prim_grid(n: int, seed: int = 7, mix: str = "full") -> Scene:
    """A scene with ``n`` field primitives (spheres/cuboids alternating).

    Tracer sweep size: ~n/2 spheres + ~n/2 three-slab boxes + 2 rects
    (ground + light).

    ``mix="diffuse"`` restricts field materials to the two diffuse
    entries: the derived config then has ``has_metallic = has_glass =
    False``, so the metallic and glass branches drop out.
    """
    rng = random.Random(seed)
    scene = Scene()

    env = scene.add_data(Data(Material.emissive((0.6, 0.7, 0.9), 0.12)))
    scene.set_root_material(env)

    side = max(1, math.ceil(math.sqrt(n)))
    pitch = 2.2
    extent = side * pitch / 2.0

    # camera looks down at the field from the +z side
    cam_pos = [0.0, extent * 0.9 + 2.0, extent * 2.2 + 4.0]
    scene.add_object(
        Object(Camera(focal_length=0.05, sensor_size=0.024, focus=None))
        .with_tag("camera")
        .with_transform(
            affine_from_rotation_translation(
                quat_from_euler_yxz(0.0, -0.35, 0.0), cam_pos
            )
        )
    )

    ground = scene.add_data(Data(Material.diffuse((0.55, 0.55, 0.58), 0.8)))
    scene.add_object(
        Object(Rect.from_edges(ground, [extent * 4, 0, 0], [0, 0, -extent * 4]))
        .with_translation([0.0, 0.0, 0.0])
    )

    light = scene.add_data(Data(Material.emissive((1.0, 0.95, 0.85), 14.0)))
    scene.add_object(
        Object(Rect.from_edges(light, [extent, 0, 0], [0, 0, -extent]))
        .with_translation([0.0, extent * 1.6 + 3.0, 0.0])
        .with_flags(ObjectFlags.LIGHT)
    )

    mats = [
        scene.add_data(Data(Material.diffuse((0.75, 0.35, 0.3), 0.7))),
        scene.add_data(Data(Material.diffuse((0.3, 0.6, 0.75), 0.7))),
    ]
    if mix == "full":
        mats += [
            scene.add_data(Data(Material.metallic((0.85, 0.8, 0.7), 0.05))),
            scene.add_data(Data(Material.glass((0.95, 0.97, 0.99), 0.0, 1.45))),
        ]
    elif mix != "diffuse":
        raise ValueError(f"unknown mix {mix!r}")

    count = 0
    for gz in range(side):
        for gx in range(side):
            if count >= n:
                break
            x = (gx + 0.5) * pitch - extent + rng.uniform(-0.3, 0.3)
            z = (gz + 0.5) * pitch - extent + rng.uniform(-0.3, 0.3)
            mat = mats[rng.randrange(len(mats))]
            if (gx + gz) % 2 == 0:
                r = rng.uniform(0.35, 0.8)
                scene.add_object(
                    Object(Sphere(material=mat, radius=r)).with_translation(
                        [x, r, z]
                    )
                )
            else:
                h = rng.uniform(0.5, 1.4)
                w = rng.uniform(0.3, 0.6)
                scene.add_object(
                    Object(
                        Cuboid.from_axes(
                            mat, [w, 0, 0], [0, h / 2, 0], [0, 0, w]
                        )
                    ).with_transform(
                        affine_from_rotation_translation(
                            quat_from_euler_yxz(rng.uniform(0.0, 1.5), 0.0, 0.0),
                            [x, h / 2, z],
                        )
                    )
                )
            count += 1
    return scene
