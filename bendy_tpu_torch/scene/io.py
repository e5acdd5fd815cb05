"""Scene (de)serialization, wire-compatible with the reference.

The reference serializes its full in-memory graph through serde_json,
optionally gzipped (``src/main.rs:93-106,299-313``). We read and write the
identical schema so the five bundled ``*.json.gz`` assets load unchanged
and scenes we save load back into the Rust binary:

- affines are 12 floats: the three 3x3 column vectors then translation
  (glam ``Affine3A`` serde layout),
- object kinds are externally-tagged enums (``"Empty"`` is a bare string,
  others ``{"Sphere": {...}}``),
- materials nest as ``{"Material": {"Diffuse": {...}}}`` under a
  ``Data { inner }`` wrapper (``src/scene/data/mod.rs:12-16``),
- collections carry their ``next_key`` (``src/scene/mod.rs:16-20``).

A copy of ``bendy_tpu/scene/io.py`` (which cannot be imported without JAX);
``dumps_scene`` output is byte-identical to it.
"""

from __future__ import annotations

import gzip
import json
from typing import Any

import numpy as np

from bendy_tpu_torch.scene.graph import (
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


def _affine_to_json(a: np.ndarray) -> list[float]:
    return [float(x) for col in range(4) for x in a[:, col]]


# -- materials --------------------------------------------------------------

def _rgb_from_json(c: dict) -> tuple[float, float, float]:
    return (c["r"], c["g"], c["b"])


def _rgb_to_json(c) -> dict:
    r, g, b = (float(x) for x in c)
    return {"r": r, "g": g, "b": b}


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


def _material_to_json(m: Material) -> dict:
    albedo = _rgb_to_json(m.albedo)
    if m.kind == "flat":
        return {"Flat": {"albedo": albedo}}
    if m.kind == "diffuse":
        return {"Diffuse": {"albedo": albedo, "roughness": m.roughness}}
    if m.kind == "metallic":
        return {"Metallic": {"albedo": albedo, "roughness": m.roughness}}
    if m.kind == "glass":
        return {"Glass": {"albedo": albedo, "roughness": m.roughness, "ior": m.ior}}
    if m.kind == "emissive":
        return {"Emissive": {"albedo": albedo, "intensity": m.intensity}}
    raise ValueError(f"unknown material kind {m.kind!r}")


def _volume_from_json(v: dict) -> DensityMap:
    dm = v["DensityMap"]
    return DensityMap(
        width=dm["width"],
        height=dm["height"],
        depth=dm["depth"],
        buffer=np.asarray(dm["buffer"], dtype=np.float32),
    )


def _volume_to_json(v: DensityMap) -> dict:
    return {
        "DensityMap": {
            "width": v.width,
            "height": v.height,
            "depth": v.depth,
            "size": [float(x) for x in v.size],
            "buffer": [float(x) for x in v.buffer],
        }
    }


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


def _rect_to_json(r: Rect) -> dict:
    return {
        "material": r.material,
        "half_width": float(r.half_width),
        "half_height": float(r.half_height),
        "x": [float(v) for v in r.x],
        "y": [float(v) for v in r.y],
        "z": [float(v) for v in r.z],
    }


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
        from bendy_tpu_torch.scene.graph import Sphere

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


def _inner_to_json(inner: Any):
    if inner is None:
        return "Empty"
    if isinstance(inner, Camera):
        return {
            "Camera": {
                "sensor_size": float(inner.sensor_size),
                "focal_length": float(inner.focal_length),
                "aspect_ratio": float(inner.aspect_ratio),
                "fstop": float(inner.fstop),
                "focus": None if inner.focus is None else float(inner.focus),
            }
        }
    from bendy_tpu_torch.scene.graph import Sphere

    if isinstance(inner, Sphere):
        return {
            "Sphere": {
                "material": inner.material,
                "volume": inner.volume,
                "radius": float(inner.radius),
            }
        }
    if isinstance(inner, Rect):
        return {"Rect": _rect_to_json(inner)}
    if isinstance(inner, Cuboid):
        return {
            "Cuboid": {
                "faces": [
                    [[float(v) for v in offset], _rect_to_json(rect)]
                    for offset, rect in inner.faces
                ]
            }
        }
    raise ValueError(f"unknown object kind {type(inner)!r}")


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
    from bendy_tpu_torch.geodesic import geo_from_dict

    scene.geodesic = doc.get("geodesic")
    geo_from_dict(scene.geodesic)
    return scene


def scene_to_dict(scene: Scene) -> dict:
    objects = {}
    for key, obj in scene.objects.items():
        objects[str(key)] = {
            "object_ref": obj.object_ref,
            "tag": obj.tag,
            "flags": {"bits": obj.flags},
            "transform": {
                "transform_world": _affine_to_json(obj.transform.world),
                "transform_local": _affine_to_json(obj.transform.local),
                "transform_parent": None
                if obj.transform.parent is None
                else _affine_to_json(obj.transform.parent),
            },
            "inner": _inner_to_json(obj.inner),
            "children": obj.children or None,
        }
    data = {}
    for key, entry in scene.data.items():
        if entry.as_material() is not None:
            inner = {"Material": _material_to_json(entry.as_material())}
        else:
            inner = {"Volume": _volume_to_json(entry.as_volume())}
        data[str(key)] = {"inner": inner}
    doc = {
        "roots": scene.roots,
        "root_material": scene.root_material,
        "objects": {"collection": objects, "next_key": scene._next_object_key},
        "data": {"collection": data, "next_key": scene._next_data_key},
    }
    if getattr(scene, "geodesic", None):
        # eager validation, mirroring the load side: a programmatically-set
        # bad block (typoed key, wrong type) must fail at save time, next
        # to the mistake, not at the eventual reload
        from bendy_tpu_torch.geodesic import geo_from_dict

        geo_from_dict(scene.geodesic)
        doc["geodesic"] = scene.geodesic
    return doc


def loads_scene(text: str) -> Scene:
    return scene_from_dict(json.loads(text))


def dumps_scene(scene: Scene) -> str:
    return json.dumps(scene_to_dict(scene), indent=2)


def load_scene(path: str) -> Scene:
    """Load a scene file; ``.gz`` paths are gunzipped (``src/main.rs:97-102``)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        return scene_from_dict(json.load(f))


def save_scene(path: str, scene: Scene) -> None:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(scene_to_dict(scene), f, indent=2)
