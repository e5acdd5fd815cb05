"""Scene loading, wire-compatible with the reference.

The reference serializes its full in-memory graph through serde_json,
optionally gzipped (``src/main.rs:93-106,299-313``). This reads the
identical schema, so the bundled ``*.json.gz`` assets load unchanged:

- affines are 12 floats: the three 3x3 column vectors then translation
  (glam ``Affine3A`` serde layout),
- object kinds are externally-tagged enums (``"Empty"`` is a bare string,
  others ``{"Sphere": {...}}``),
- materials nest as ``{"Material": {"Diffuse": {...}}}`` under a
  ``Data { inner }`` wrapper (``src/scene/data/mod.rs:12-16``),
- collections carry their ``next_key`` (``src/scene/mod.rs:16-20``).

A copy of the port's ``scene/io.py`` without its writers.
"""

from __future__ import annotations

import gzip
import json
from typing import Any

import numpy as np

from .graph import (
    Camera,
    Cuboid,
    Data,
    DensityMap,
    Material,
    Object,
    Rect,
    Scene,
    Transform,
)

# -- affine <-> 12 floats ---------------------------------------------------


def _affine_from_json(vals: list[float]) -> np.ndarray:
    a = np.empty((3, 4), dtype=np.float64)
    a[:, 0] = vals[0:3]
    a[:, 1] = vals[3:6]
    a[:, 2] = vals[6:9]
    a[:, 3] = vals[9:12]
    return a


# -- materials --------------------------------------------------------------

def _rgb_from_json(c: dict) -> tuple[float, float, float]:
    return (c["r"], c["g"], c["b"])


def _material_from_json(m: dict) -> Material:
    (kind, fields), = m.items()
    albedo = _rgb_from_json(fields["albedo"])
    if kind == "Flat":
        return Material.flat(albedo)
    if kind == "Diffuse":
        return Material.diffuse(albedo, fields["roughness"])
    if kind == "Metallic":
        return Material.metallic(albedo, fields["roughness"])
    if kind == "Glass":
        return Material.glass(albedo, fields["roughness"], fields["ior"])
    if kind == "Emissive":
        return Material.emissive(albedo, fields["intensity"])
    raise ValueError(f"unknown material kind {kind!r}")


def _volume_from_json(v: dict) -> DensityMap:
    dm = v["DensityMap"]
    return DensityMap(
        width=dm["width"],
        height=dm["height"],
        depth=dm["depth"],
        buffer=np.asarray(dm["buffer"], dtype=np.float32),
    )


# -- shapes -----------------------------------------------------------------


def _rect_from_json(r: dict) -> Rect:
    return Rect(
        material=r["material"],
        half_width=r["half_width"],
        half_height=r["half_height"],
        x=np.asarray(r["x"], dtype=np.float64),
        y=np.asarray(r["y"], dtype=np.float64),
        z=np.asarray(r["z"], dtype=np.float64),
    )


def _inner_from_json(inner: Any):
    if inner == "Empty":
        return None
    (kind, fields), = inner.items()
    if kind == "Camera":
        return Camera(
            sensor_size=fields["sensor_size"],
            focal_length=fields["focal_length"],
            aspect_ratio=fields["aspect_ratio"],
            fstop=fields["fstop"],
            focus=fields["focus"],
        )
    if kind == "Sphere":
        from .graph import Sphere

        return Sphere(material=fields["material"], radius=fields["radius"], volume=fields["volume"])
    if kind == "Rect":
        return _rect_from_json(fields)
    if kind == "Cuboid":
        faces = [
            (np.asarray(offset, dtype=np.float64), _rect_from_json(rect))
            for offset, rect in fields["faces"]
        ]
        return Cuboid(faces=faces)
    raise ValueError(f"unknown object kind {kind!r}")


# -- scene ------------------------------------------------------------------


def scene_from_dict(doc: dict) -> Scene:
    scene = Scene.__new__(Scene)
    scene.roots = list(doc["roots"])
    scene.root_material = doc["root_material"]
    scene.objects = {}
    scene.data = {}

    for key, entry in doc["objects"]["collection"].items():
        tf = entry["transform"]
        transform = Transform(
            world=_affine_from_json(tf["transform_world"]),
            local=_affine_from_json(tf["transform_local"]),
            parent=None
            if tf["transform_parent"] is None
            else _affine_from_json(tf["transform_parent"]),
        )
        obj = Object(
            inner=_inner_from_json(entry["inner"]),
            tag=entry["tag"],
            flags=entry["flags"]["bits"],
            transform=transform,
            children=list(entry["children"] or []),
            object_ref=entry["object_ref"],
        )
        scene.objects[int(key)] = obj

    for key, entry in doc["data"]["collection"].items():
        inner = entry["inner"]
        (kind, fields), = inner.items()
        if kind == "Material":
            scene.data[int(key)] = Data(_material_from_json(fields))
        elif kind == "Volume":
            scene.data[int(key)] = Data(_volume_from_json(fields))
        else:
            raise ValueError(f"unknown data kind {kind!r}")

    scene._next_object_key = doc["objects"]["next_key"]
    scene._next_data_key = doc["data"]["next_key"]
    # extension block: per-scene geodesic overrides (validated eagerly so a
    # typo fails at load, not mid-render)
    from .geodesic import geo_from_dict

    scene.geodesic = doc.get("geodesic")
    geo_from_dict(scene.geodesic)
    return scene


def load_scene(path: str) -> Scene:
    """Load a scene file; ``.gz`` paths are gunzipped (``src/main.rs:97-102``)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        return scene_from_dict(json.load(f))


