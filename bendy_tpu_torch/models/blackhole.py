"""Lensed black-hole showcase scene (the BASELINE.json north-star config).

A Schwarzschild mass (rs = 1) at the origin — expressed as an Empty object
tagged ``mass:1.0`` so it round-trips through the reference-compatible
scene schema — surrounded by emissive spheres whose images the hole warps
into arcs/Einstein rings, plus a square ring of emissive "accretion" rects
in the equatorial plane. The horizon itself needs no geometry: lanes whose
geodesics dip below rs are captured by the integrator.

A copy of ``bendy_tpu/models/blackhole.py`` with its imports pointed at
``bendy_tpu_torch.scene.graph`` (the reference's cannot be imported
without jax); ``dumps_scene`` of either build is byte-equal.
"""

from __future__ import annotations

from bendy_tpu_torch.scene.graph import (
    Camera,
    Data,
    Material,
    Object,
    ObjectFlags,
    Rect,
    Scene,
    Sphere,
)


def build_blackhole(rs: float = 1.0) -> Scene:
    scene = Scene()

    # dim gray environment so captured lanes read as a black shadow
    env = scene.add_data(Data(Material.emissive((0.35, 0.38, 0.45), 0.02)))
    scene.set_root_material(env)

    scene.add_object(Object().with_tag(f"mass:{rs}"))
    scene.add_object(
        Object(Camera(focal_length=0.05, sensor_size=0.024, focus=None))
        .with_tag("camera")
        .with_translation([0.0, 1.5, 22.0])
    )

    # background "stars": emissive spheres behind the hole
    star_cols = [
        ((1.0, 0.75, 0.45), 1.6),
        ((0.55, 0.75, 1.0), 1.5),
        ((1.0, 0.45, 0.35), 1.4),
        ((0.75, 1.0, 0.6), 1.3),
    ]
    positions = [
        (-7.0, 3.0, -30.0),
        (6.0, -2.0, -35.0),
        (0.0, 6.5, -32.0),
        (-2.0, -6.0, -28.0),
        # one source almost exactly behind the hole -> Einstein ring
        (0.3, 0.2, -40.0),
    ]
    for i, pos in enumerate(positions):
        albedo, inten = star_cols[i % len(star_cols)]
        mat = scene.add_data(Data(Material.emissive(albedo, inten)))
        scene.add_object(
            Object(Sphere(material=mat, radius=1.2)).with_translation(pos).with_flags(
                ObjectFlags.LIGHT
            )
        )

    # square "accretion ring" of hot emissive rects in the equatorial plane
    hot = scene.add_data(Data(Material.emissive((1.0, 0.62, 0.22), 2.4)))
    inner, outer = 3.0 * rs, 7.0 * rs
    half_w = (outer - inner) / 2.0
    mid = (outer + inner) / 2.0
    for dx, dz, ex, ez in [
        (mid, 0.0, half_w, outer),
        (-mid, 0.0, half_w, outer),
        (0.0, mid, inner, half_w),
        (0.0, -mid, inner, half_w),
    ]:
        scene.add_object(
            Object(Rect.from_edges(hot, [ex, 0, 0], [0, 0, ez]))
            .with_translation([dx, 0.0, dz])
            .with_flags(ObjectFlags.LIGHT)
        )

    # a glossy probe sphere in the foreground catches lensed reflections
    probe = scene.add_data(Data(Material.metallic((0.7, 0.7, 0.75), 0.05)))
    scene.add_object(Object(Sphere(material=probe, radius=1.0)).with_translation([4.5, -1.0, 6.0]))

    return scene
