"""Host-side scene graph.

A Python re-design of the reference's scene layer (``src/scene/``):
keyed object/data collections with monotonic ids (``src/scene/mod.rs:16-73``),
hierarchical world/local/parent transforms (``src/scene/object/transform.rs``),
a deferred update queue that drains re-enqueued updates to a fixed point
(``src/scene/mod.rs:154-212``), and the same five material kinds /
three shapes / density-map volumes.

This layer is pure host code (numpy); the device-side representation is
produced by :mod:`bendy_tpu_torch.scene.compiler`.

A copy of ``bendy_tpu/scene/graph.py``: importing that module would import
``bendy_tpu/scene/__init__.py``, which pulls in JAX.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Union

import numpy as np

# --------------------------------------------------------------------------
# affine transforms (3x3 linear part + translation, like glam's Affine3A)


def affine_identity() -> np.ndarray:
    """4x3-equivalent affine stored as a (3,4) array [R | t]."""
    out = np.zeros((3, 4), dtype=np.float64)
    out[:, :3] = np.eye(3)
    return out


def affine_from_translation(t) -> np.ndarray:
    a = affine_identity()
    a[:, 3] = np.asarray(t, dtype=np.float64)
    return a


def affine_from_rotation_translation(quat, t) -> np.ndarray:
    a = affine_identity()
    a[:, :3] = quat_to_matrix(np.asarray(quat, dtype=np.float64))
    a[:, 3] = np.asarray(t, dtype=np.float64)
    return a


def affine_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Compose affines: (a*b)(p) = a(b(p))."""
    out = np.empty((3, 4), dtype=np.float64)
    out[:, :3] = a[:, :3] @ b[:, :3]
    out[:, 3] = a[:, :3] @ b[:, 3] + a[:, 3]
    return out


def affine_inverse(a: np.ndarray) -> np.ndarray:
    out = np.empty((3, 4), dtype=np.float64)
    inv = np.linalg.inv(a[:, :3])
    out[:, :3] = inv
    out[:, 3] = -inv @ a[:, 3]
    return out


def transform_point(a: np.ndarray, p) -> np.ndarray:
    return a[:, :3] @ np.asarray(p, dtype=np.float64) + a[:, 3]


def transform_vector(a: np.ndarray, v) -> np.ndarray:
    return a[:, :3] @ np.asarray(v, dtype=np.float64)


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ]
    )


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


@dataclass
class Transform:
    """World/local/parent transform triple (``src/scene/object/transform.rs``)."""

    world: np.ndarray = field(default_factory=affine_identity)
    local: np.ndarray = field(default_factory=affine_identity)
    parent: Optional[np.ndarray] = None

    def set_world(self, a: np.ndarray) -> None:
        self.world = a
        self.local = affine_mul(affine_inverse(self.parent), a) if self.parent is not None else a

    def set_local(self, a: np.ndarray) -> None:
        self.local = a
        self.world = affine_mul(self.parent, a) if self.parent is not None else a

    def set_parent(self, a: np.ndarray) -> None:
        """Reparent: world = parent * local (``transform.rs:44-47``)."""
        self.parent = a
        self.world = affine_mul(a, self.local)


# --------------------------------------------------------------------------
# materials & volumes


@dataclass
class Material:
    """Tagged material (``src/scene/data/material.rs:23-44``).

    kind: 'flat' | 'diffuse' | 'metallic' | 'glass' | 'emissive'
    """

    kind: str
    albedo: tuple[float, float, float]
    roughness: float = 0.0
    ior: float = 1.0
    intensity: float = 0.0

    @staticmethod
    def flat(albedo) -> "Material":
        return Material("flat", tuple(albedo))

    @staticmethod
    def diffuse(albedo, roughness: float) -> "Material":
        return Material("diffuse", tuple(albedo), roughness=roughness)

    @staticmethod
    def metallic(albedo, roughness: float) -> "Material":
        return Material("metallic", tuple(albedo), roughness=roughness)

    @staticmethod
    def glass(albedo, roughness: float, ior: float) -> "Material":
        return Material("glass", tuple(albedo), roughness=roughness, ior=ior)

    @staticmethod
    def emissive(albedo, intensity: float) -> "Material":
        return Material("emissive", tuple(albedo), intensity=intensity)


@dataclass
class DensityMap:
    """3-D scalar density grid (``src/scene/data/volume.rs:76-117``).

    ``buffer`` is stored x-fastest: index = z*h*w + y*w + x
    (``volume.rs:132``); ``size`` is (w-1, h-1, d-1) for normalized-coord
    scaling (``volume.rs:86``).
    """

    width: int
    height: int
    depth: int
    buffer: np.ndarray  # flat, length w*h*d

    @property
    def size(self) -> np.ndarray:
        return np.array([self.width - 1.0, self.height - 1.0, self.depth - 1.0])

    @staticmethod
    def with_value(w: int, h: int, d: int, value: float) -> "DensityMap":
        return DensityMap(w, h, d, np.full(w * h * d, value, dtype=np.float32))

    @staticmethod
    def with_func(w: int, h: int, d: int, f: Callable[[int, int, int], float]) -> "DensityMap":
        buf = np.empty(w * h * d, dtype=np.float32)
        for i in range(w * h * d):
            x = i % w
            yz = i // w
            buf[i] = f(x, yz % h, yz // h)
        return DensityMap(w, h, d, buf)

    def grid(self) -> np.ndarray:
        """Return the buffer as a [depth, height, width] array."""
        return self.buffer.reshape(self.depth, self.height, self.width)

    def index(self, x: int, y: int, z: int) -> float:
        """Bounds-checked raw access (``volume.rs:119-134``)."""
        if self.width == 0 or self.height == 0 or self.depth == 0:
            return 0.0
        assert 0 <= x < self.width and 0 <= y < self.height and 0 <= z < self.depth, \
            "volume index out of bounds"
        return float(self.buffer[z * self.height * self.width + y * self.width + x])

    def sample(self, coord, mode: str = "trilinear") -> float:
        """Host-side density lookup (``volume.rs:140-166``).

        coord in [0,1]^3; mode 'nearest' or 'trilinear' (the reference's
        ``SamplingMode``; its tracer always uses trilinear).
        """
        c = np.clip(np.asarray(coord, np.float64), 0.0, 1.0) * self.size
        if mode == "nearest":
            # Rust f32::round = half away from zero (coords non-negative)
            i = np.floor(c + 0.5).astype(int)
            return self.index(i[0], i[1], i[2])
        if mode != "trilinear":
            raise ValueError(f"unknown sampling mode {mode!r}")
        lo = np.floor(c).astype(int)
        hi = np.minimum(lo + 1, self.size.astype(int))
        f = c - lo

        def at(xi, yi, zi):
            return self.index(xi, yi, zi)

        def lerp(a, b, t):
            return a + (b - a) * t

        y0 = lerp(at(lo[0], lo[1], lo[2]), at(hi[0], lo[1], lo[2]), f[0])
        y1 = lerp(at(lo[0], hi[1], lo[2]), at(hi[0], hi[1], lo[2]), f[0])
        z0 = lerp(y0, y1, f[1])
        y0 = lerp(at(lo[0], lo[1], hi[2]), at(hi[0], lo[1], hi[2]), f[0])
        y1 = lerp(at(lo[0], hi[1], hi[2]), at(hi[0], hi[1], hi[2]), f[0])
        z1 = lerp(y0, y1, f[1])
        return float(lerp(z0, z1, f[2]))


@dataclass
class Data:
    """Material-or-volume registry entry (``src/scene/data/mod.rs:12-51``)."""

    inner: Union[Material, DensityMap]

    def as_material(self) -> Optional[Material]:
        return self.inner if isinstance(self.inner, Material) else None

    def as_volume(self) -> Optional[DensityMap]:
        return self.inner if isinstance(self.inner, DensityMap) else None


# --------------------------------------------------------------------------
# shapes


@dataclass
class Camera:
    """Pure camera data (``src/scene/object/camera.rs``); optics math lives
    in :mod:`bendy_tpu_torch.ops.camera`."""

    sensor_size: float = 0.024
    focal_length: float = 0.05
    aspect_ratio: float = 1.5
    fstop: float = 2.0
    focus: Optional[float] = None


@dataclass
class Sphere:
    material: int
    radius: float
    volume: Optional[int] = None


@dataclass
class Rect:
    """Oriented rectangle: orthonormal basis + half extents
    (``src/scene/object/rect.rs:22-36``)."""

    material: int
    half_width: float
    half_height: float
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray

    @staticmethod
    def from_edges(material: int, x_edge, y_edge) -> "Rect":
        x_edge = np.asarray(x_edge, dtype=np.float64)
        y_edge = np.asarray(y_edge, dtype=np.float64)
        hw = float(np.linalg.norm(x_edge))
        hh = float(np.linalg.norm(y_edge))
        x = x_edge / hw
        y = y_edge / hh
        return Rect(material, hw, hh, x, y, np.cross(x, y))

    @property
    def area(self) -> float:
        return 4.0 * self.half_width * self.half_height


@dataclass
class Cuboid:
    """Six outward rects with per-face offsets (``src/scene/object/cuboid.rs:19-30``)."""

    faces: list  # [(offset ndarray[3], Rect)] * 6

    @staticmethod
    def from_axes(material: int, x, y, z) -> "Cuboid":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        z = np.asarray(z, dtype=np.float64)
        return Cuboid(
            faces=[
                (-z, Rect.from_edges(material, x, y)),
                (z, Rect.from_edges(material, -x, y)),
                (-x, Rect.from_edges(material, z, y)),
                (x, Rect.from_edges(material, -z, y)),
                (-y, Rect.from_edges(material, x, z)),
                (y, Rect.from_edges(material, x, -z)),
            ]
        )


# --------------------------------------------------------------------------
# objects & scene


class ObjectFlags:
    NONE = 0
    LIGHT = 0x1


@dataclass
class Object:
    """Scene node (``src/scene/object/mod.rs:33-41``)."""

    inner: Union[None, Camera, Sphere, Rect, Cuboid] = None
    tag: Optional[str] = None
    flags: int = ObjectFlags.NONE
    transform: Transform = field(default_factory=Transform)
    children: list[int] = field(default_factory=list)
    object_ref: Optional[int] = None

    def with_tag(self, tag: str) -> "Object":
        self.tag = tag
        return self

    def with_flags(self, flags: int) -> "Object":
        self.flags |= flags
        return self

    def with_transform(self, affine: np.ndarray) -> "Object":
        self.transform = Transform(world=affine.copy(), local=affine.copy())
        return self

    def with_translation(self, t) -> "Object":
        return self.with_transform(affine_from_translation(t))

    def with_rotation(self, t, quat) -> "Object":
        return self.with_transform(affine_from_rotation_translation(quat, t))

    def has_flags(self, flags: int) -> bool:
        return (self.flags & flags) == flags

    def as_camera(self) -> Optional[Camera]:
        return self.inner if isinstance(self.inner, Camera) else None

    # -- hierarchy (mirrors ``src/scene/object/mod.rs:200-244``) ----------

    def apply_parent_transform(self, queue: "UpdateQueue", affine: np.ndarray) -> None:
        self.transform.set_parent(affine)
        world = self.transform.world
        for child in self.children:
            queue.push(
                Update.object(child, lambda o, q, _d, w=world: o.apply_parent_transform(q, w))
            )

    def apply_transform(self, queue: "UpdateQueue", affine: np.ndarray) -> None:
        self.transform.set_local(affine_mul(self.transform.local, affine))
        world = self.transform.world
        for child in self.children:
            queue.push(
                Update.object(child, lambda o, q, _d, w=world: o.apply_parent_transform(q, w))
            )

    def add(self, queue: "UpdateQueue", child: int) -> None:
        world = self.transform.world
        queue.push(Update.object(child, lambda o, q, _d, w=world: o.apply_parent_transform(q, w)))
        self.children.append(child)


class Scene:
    """Object + data registries (``src/scene/mod.rs:84-146``).

    A fresh scene gets a flat-black root (environment) material, exactly
    like ``Scene::new`` (``src/scene/mod.rs:92-104``).
    """

    def __init__(self) -> None:
        self.roots: list[int] = []
        self.objects: dict[int, Object] = {}
        self.data: dict[int, Data] = {}
        self._next_object_key = 0
        self._next_data_key = 0
        self.root_material = self.add_data(Data(Material.flat((0.0, 0.0, 0.0))))
        # optional per-scene geodesic-integration overrides (a mapping of
        # GeoParams fields, carried in the scene file's "geodesic" block —
        # an extension; the reference schema has no geodesic capability)
        self.geodesic: Optional[dict] = None

    def add_object(self, obj: Object) -> int:
        key = self._next_object_key
        obj.object_ref = key
        self.objects[key] = obj
        self._next_object_key += 1
        return key

    def add_data(self, data: Data) -> int:
        key = self._next_data_key
        self.data[key] = data
        self._next_data_key += 1
        return key

    def get_object(self, ref: int) -> Object:
        return self.objects[ref]

    def get_data(self, ref: int) -> Data:
        return self.data[ref]

    def root_material_data(self) -> Material:
        mat = self.data[self.root_material].as_material()
        assert mat is not None, "expected root material to be a material"
        return mat

    def set_root_material(self, ref: int) -> None:
        self.root_material = ref

    def find_by_tag(self, tag: str) -> Optional[int]:
        for ref, obj in self.objects.items():
            if obj.tag == tag:
                return ref
        return None

    def iter(self) -> Iterable[Object]:
        return self.objects.values()

    def pairs(self) -> Iterable[tuple[int, Object]]:
        return self.objects.items()


# --------------------------------------------------------------------------
# deferred update queue (``src/scene/mod.rs:154-239``)


class Update:
    def __init__(self, kind: str, ref: Optional[int], func: Callable) -> None:
        self.kind = kind
        self.ref = ref
        self.func = func

    @staticmethod
    def object(ref: int, func: Callable) -> "Update":
        return Update("object", ref, func)

    @staticmethod
    def all_objects(func: Callable) -> "Update":
        return Update("all", None, func)


class UpdateQueue:
    """FIFO of deferred mutations; ``commit`` drains repeatedly until no
    update enqueues further work (``src/scene/mod.rs:203-212``)."""

    def __init__(self) -> None:
        self.queue: deque[Update] = deque()

    def push(self, update: Update) -> None:
        self.queue.append(update)

    def __len__(self) -> int:
        return len(self.queue)

    def commit(self, scene: Scene) -> None:
        pending = self.queue
        self.queue = deque()
        while pending:
            next_queue = UpdateQueue()
            for update in pending:
                if update.kind == "object":
                    update.func(scene.objects[update.ref], next_queue, scene.data)
                else:
                    for obj in scene.objects.values():
                        update.func(obj, next_queue, scene.data)
            pending = next_queue.queue
