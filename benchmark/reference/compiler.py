"""Scene compiler: host scene graph -> flat SoA tables (numpy + torch).

Counterpart of ``bendy_tpu/scene/compiler.py``. The tables are the port's
state in place of weights: field names, shapes, dtypes and values are
identical to ``bendy_tpu.scene.compile_scene(s).host_copy()``, so the
reference's numpy host copy converts straight into the port
(:func:`scene_arrays_from_numpy`) and every consumer sees one layout.

What the compiler bakes per primitive:

- cuboids decompose into their six world-space rect faces
  (``src/scene/object/cuboid.rs:19-30``); each face bakes the *full
  affine* (plane normal, inverse-transposed containment bases and forward
  sampling bases, see ``add_rect``). Closed single-material cuboids also
  compile into three-slab box form. Spheres take only the transform's
  translation (``sphere.rs:121-148``),
- each primitive carries its material's parameters inline (type code,
  albedo, roughness, ior, emitted),
- each volume sphere carries its density grid's index and dimensions,
- LIGHT-flagged objects get a geometry table for next-event sampling
  (``material.rs:106-122``, ``cuboid.rs:48-54``),
- density grids are zero-padded to a common shape, stacked [G, D, H, W].

Counts are exact (no padding). The CUDA tracer reads the counts at run
time, so editing or moving an object rebuilds nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .graph import (
    Cuboid,
    ObjectFlags,
    Rect,
    Scene,
    Sphere,
    transform_point,
)

MAX_LIGHT_FACES = 6  # a cuboid light contributes 6 faces (upper bound; the
#   compiled face axis F is sized to the scene's actual max — every bundled
#   scene has single-face rect or sphere lights, so F is usually 1, and the
#   per-iteration light sweeps in ops/intersect.light_pdf and
#   ops/materials.sample_light_point shrink with it)

MAT_FLAT = 0
MAT_DIFFUSE = 1
MAT_METALLIC = 2
MAT_GLASS = 3
MAT_EMISSIVE = 4

BOX_COMPILE = True  # module switch: False forces the per-face rect sweep
#   for every cuboid (tests use it to pin box/rect equivalence)

_MATERIAL_CODES = {
    "flat": MAT_FLAT,
    "diffuse": MAT_DIFFUSE,
    "metallic": MAT_METALLIC,
    "glass": MAT_GLASS,
    "emissive": MAT_EMISSIVE,
}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    return dev


def _emitted_of(m) -> np.ndarray:
    """emitted(): Flat -> albedo, Emissive -> albedo·intensity, else 0
    (``src/scene/data/material.rs:71-79``)."""
    if m.kind == "flat":
        return np.asarray(m.albedo, np.float32)
    if m.kind == "emissive":
        return np.asarray(m.albedo, np.float32) * np.float32(m.intensity)
    return np.zeros(3, np.float32)


@dataclass(frozen=True)
class SceneArrays:
    """Compiled scene; every field is a torch tensor on one device, or a
    numpy array in the host copy (:meth:`host_copy`).

    Shapes: Ns spheres, Nr rects (stand-alone + cuboid faces), L lights,
    G density grids. Counts are exact; the plain integrator unrolls over
    them and the CUDA tracer reads them at run time.
    """

    # spheres: geometry + inline material + volume binding
    sph_center: torch.Tensor  # [Ns,3]
    sph_radius: torch.Tensor  # [Ns]
    sph_mtype: torch.Tensor  # [Ns] material code
    sph_albedo: torch.Tensor  # [Ns,3]
    sph_rough: torch.Tensor  # [Ns]
    sph_ior: torch.Tensor  # [Ns]
    sph_emitted: torch.Tensor  # [Ns,3]
    sph_vol_grid: torch.Tensor  # [Ns] density grid index, -1 = no volume
    sph_vol_size: torch.Tensor  # [Ns,3] grid (w-1,h-1,d-1)

    # rects: geometry + inline material
    rct_center: torch.Tensor  # [Nr,3] world face center
    rct_x: torch.Tensor  # [Nr,3] inverse-transposed local basis (M^-T x̂):
    #   containment is (p-c)·rct_x in [-hw,hw] — exact under any affine,
    #   and equal to the world basis when the transform is rigid
    rct_y: torch.Tensor  # [Nr,3]
    rct_z: torch.Tensor  # [Nr,3] world unit face normal (∝ fx × fy)
    rct_fx: torch.Tensor  # [Nr,3] forward world basis M·x̂ (non-unit under
    #   scale); light sampling + world-area terms
    rct_fy: torch.Tensor  # [Nr,3]
    rct_hw: torch.Tensor  # [Nr]
    rct_hh: torch.Tensor  # [Nr]
    rct_mtype: torch.Tensor  # [Nr]
    rct_albedo: torch.Tensor  # [Nr,3]
    rct_rough: torch.Tensor  # [Nr]
    rct_ior: torch.Tensor  # [Nr]
    rct_emitted: torch.Tensor  # [Nr,3]

    # boxes: cuboids whose six faces form a closed parallelepiped with one
    # material compile ADDITIONALLY into three-slab form — the tracer
    # intersects the whole box in ~3 plane tests instead of 6 rect tests
    # (ops/intersect.nearest_hit). Their face rects stay in the rect table
    # (ordered last) for the native/numpy oracles and light-row mapping;
    # the tracer sweeps only the first n_trace_rects rows.
    box_n: torch.Tensor  # [Nb,3,3] unit slab normals
    box_dlo: torch.Tensor  # [Nb,3] slab plane offsets: n·x ∈ [dlo, dhi]
    box_dhi: torch.Tensor  # [Nb,3]
    box_sgn_lo: torch.Tensor  # [Nb,3] ±1: stored-normal sign (vs slab n) of
    #   the face on the lo plane — the reference's front/back face codes
    #   follow each face's own stored orientation
    box_sgn_hi: torch.Tensor  # [Nb,3]
    box_mtype: torch.Tensor  # [Nb]
    box_albedo: torch.Tensor  # [Nb,3]
    box_rough: torch.Tensor  # [Nb]
    box_ior: torch.Tensor  # [Nb]
    box_emitted: torch.Tensor  # [Nb,3]
    rct_traced: torch.Tensor  # [Nt] int32 arange — rows the tracer sweeps
    #   (box-owned face rows sit at the end of the rect table, past Nt)

    # environment (root material, ``src/scene/mod.rs:92-104``)
    root_mtype: torch.Tensor  # [] int32
    root_albedo: torch.Tensor  # [3]
    root_emitted: torch.Tensor  # [3]

    # lights (``ObjectFlags::LIGHT`` objects)
    light_kind: torch.Tensor  # [L] 0=sphere 1=rect(s)
    light_sph_center: torch.Tensor  # [L,3]
    light_sph_radius: torch.Tensor  # [L]
    light_face_center: torch.Tensor  # [L,F,3]
    light_face_x: torch.Tensor  # [L,F,3] forward basis M·x̂ (random_point)
    light_face_y: torch.Tensor  # [L,F,3]
    light_face_ux: torch.Tensor  # [L,F,3] inverse-transposed basis (containment)
    light_face_uy: torch.Tensor  # [L,F,3]
    light_face_z: torch.Tensor  # [L,F,3] unit face normal
    light_face_hw: torch.Tensor  # [L,F]
    light_face_hh: torch.Tensor  # [L,F]
    light_face_area: torch.Tensor  # [L,F] world-space face area (4·hw·hh·|fx×fy|)
    light_face_cdf: torch.Tensor  # [L,F] cumulative area weights
    light_face_valid: torch.Tensor  # [L,F] bool
    light_sph_row: torch.Tensor  # [L] sphere row of a sphere light, -1 otherwise
    light_rct_rows: torch.Tensor  # [L,F] rect rows of a rect/cuboid light, -1 pad

    # volumes: stacked density grids
    vol_grid: torch.Tensor  # [G, D, H, W]

    # geodesic masses (objects tagged "mass:<rs>"; empty in flat scenes)
    mass_center: torch.Tensor  # [M,3]
    mass_rs: torch.Tensor  # [M] Schwarzschild radius

    def host_copy(self) -> "SceneArrays":
        """Numpy-leaved copy (the layout of ``bendy_tpu``'s ``host_copy``).

        ``compile_scene`` stashes the numpy originals under ``_host`` so no
        device round-trip is needed.
        """
        stash = getattr(self, "_host", None)
        if stash is not None:
            return stash
        return SceneArrays(**{
            f.name: np.asarray(torch.as_tensor(getattr(self, f.name)).cpu())
            for f in fields(self)
        })

    @property
    def device(self) -> torch.device:
        return self.sph_radius.device

    @property
    def n_spheres(self) -> int:
        return self.sph_radius.shape[0]

    @property
    def n_rects(self) -> int:
        return self.rct_hw.shape[0]

    @property
    def n_trace_rects(self) -> int:
        """Rect rows the tracer sweeps (excludes box-owned faces)."""
        return self.rct_traced.shape[0]

    @property
    def n_boxes(self) -> int:
        return self.box_rough.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_kind.shape[0]

    @property
    def n_masses(self) -> int:
        return self.mass_rs.shape[0]

    @property
    def has_volumes(self) -> bool:
        return bool(self.vol_grid.shape[1] > 1)


def validate_scene(scene: Scene) -> None:
    """Compile-time scene validation: loud errors where the reference
    panics or silently misbehaves.

    - Diffuse materials with zero LIGHT-flagged objects: the reference's
      next-event sampler panics (``material.rs:112`` — ``Uniform::new(0,0)``);
      rendering with a phantom light would be silently wrong.
    - Degenerate (non-invertible / zero-area) transforms on rects or
      cuboid faces: no geometry can be compiled for them.
    """
    lights = [obj for obj in scene.iter() if obj.has_flags(ObjectFlags.LIGHT)]
    diffuse_users = []
    for ref, obj in scene.pairs():
        inner = obj.inner
        mats = []
        if isinstance(inner, Sphere) or isinstance(inner, Rect):
            mats = [inner.material]
        elif isinstance(inner, Cuboid):
            mats = [r.material for _, r in inner.faces]
        for mref in mats:
            m = scene.data[mref].as_material()
            if m is not None and m.kind == "diffuse":
                diffuse_users.append(obj.tag or f"object#{ref}")
                break
    if diffuse_users and not lights:
        raise ValueError(
            "scene uses Diffuse materials "
            f"({', '.join(sorted(set(diffuse_users)))}) but has no object "
            "with ObjectFlags.LIGHT — Diffuse next-event sampling needs at "
            "least one light (the reference panics here, material.rs:112). "
            "Flag an emissive object with ObjectFlags.LIGHT."
        )
    for ref, obj in scene.pairs():
        if isinstance(obj.inner, (Rect, Cuboid)):
            m_lin = obj.transform.world[:, :3]
            if abs(np.linalg.det(m_lin)) < 1e-12:
                raise ValueError(
                    f"object {obj.tag or ref!r} has a singular (non-invertible) "
                    "transform; rect/cuboid faces cannot be hit-tested under it"
                )


def compile_scene(scene: Scene, device="cuda") -> SceneArrays:
    """Flatten a committed scene graph into SoA tensors on ``device`` (the
    card unless the caller asks for the CPU; raises without a card)."""
    device = resolve_device(device)
    validate_scene(scene)
    vol_keys = sorted(k for k, d in scene.data.items() if d.as_volume() is not None)
    vol_index = {k: i for i, k in enumerate(vol_keys)}

    def mat(key):
        m = scene.data[key].as_material()
        assert m is not None, "expected material data"
        return m

    sph = {k: [] for k in ("center", "radius", "mtype", "albedo", "rough", "ior",
                           "emitted", "vol_grid", "vol_size")}
    rct = {k: [] for k in ("center", "x", "y", "z", "fx", "fy", "hw", "hh",
                           "mtype", "albedo", "rough", "ior", "emitted")}
    sphere_row_of_obj: dict[int, int] = {}
    rect_rows_of_obj: dict[int, list[int]] = {}

    def face_geometry(world, rect: Rect):
        """World-space face geometry under a general affine [M | t].

        The reference applies the affine at hit time (``rect.rs:110-142``):
        plane from the transformed normal, containment from the *inverse*
        transform projected on the local unit bases. Baked equivalents:

            fx, fy = M·x̂, M·ŷ          (forward bases; random_point,
                                         ``rect.rs:82-86``, world area)
            ux, uy = M⁻ᵀ·x̂, M⁻ᵀ·ŷ      (containment: (p−c)·ux ≡
                                         (A⁻¹p)·x̂, the exact test at
                                         ``rect.rs:74-80,134``)
            n̂ = normalize(fx × fy)     (true plane of the transformed
                                         face; ∝ M⁻ᵀ·ẑ)

        For rigid transforms ux = fx = M·x̂ and n̂ = M·ẑ — identical to the
        reference. Documented divergences for non-rigid transforms, where
        the reference is itself inconsistent (debug builds assert on the
        non-unit normal, ``Cargo.toml:19``):
        - the reference intersects the plane with the unnormalized,
          generally *tilted* M·ẑ (wrong plane under shear); we use the
          face's true normal,
        - the reference weights light pdfs by the local (pre-transform)
          area; we use the world-space area, which is the correct density
          for its own ``random_point`` (uniform in local coords mapped
          through A ⇒ uniform on the world parallelogram).
        """
        m_lin = world[:, :3]
        fx = m_lin @ np.asarray(rect.x, np.float64)
        fy = m_lin @ np.asarray(rect.y, np.float64)
        n_raw = np.cross(fx, fy)
        n_len = np.linalg.norm(n_raw)
        if n_len < 1e-12:
            raise ValueError("degenerate rect face (zero world area)")
        minv_t = np.linalg.inv(m_lin).T
        return (
            fx, fy, n_raw / n_len,
            minv_t @ np.asarray(rect.x, np.float64),
            minv_t @ np.asarray(rect.y, np.float64),
        )

    def world_area(world, rect: Rect) -> float:
        m_lin = world[:, :3]
        e = np.cross(m_lin @ np.asarray(rect.x, np.float64),
                     m_lin @ np.asarray(rect.y, np.float64))
        return float(rect.area * np.linalg.norm(e))

    def add_rect(world, offset, rect: Rect) -> None:
        m = mat(rect.material)
        fx, fy, nz, ux, uy = face_geometry(world, rect)
        rct["center"].append(transform_point(world, offset))
        rct["x"].append(ux)
        rct["y"].append(uy)
        rct["z"].append(nz)
        rct["fx"].append(fx)
        rct["fy"].append(fy)
        rct["hw"].append(rect.half_width)
        rct["hh"].append(rect.half_height)
        rct["mtype"].append(_MATERIAL_CODES[m.kind])
        rct["albedo"].append(m.albedo)
        rct["rough"].append(m.roughness)
        rct["ior"].append(m.ior)
        rct["emitted"].append(_emitted_of(m))

    box = {k: [] for k in ("n", "dlo", "dhi", "sgn_lo", "sgn_hi", "mtype",
                           "albedo", "rough", "ior", "emitted")}

    def box_slabs(world, faces):
        """(normals [3,3], dlo [3], dhi [3]) when the six faces form a
        closed single-material parallelepiped, else None.

        Affine transforms preserve face parallelism, so a true cuboid's
        world faces always pair into three slabs; the check is numeric
        (on the serialized data, not the constructor) because the scene
        schema admits arbitrary ``(offset, Rect)`` sextuples
        (``src/scene/object/cuboid.rs:14-30``) — anything that is not an
        exact box falls back to the generic per-face rect sweep.
        """
        if not BOX_COMPILE or len(faces) != 6:
            return None
        if len({r.material for _, r in faces}) != 1:
            return None
        geom, corners = [], []
        for off, r in faces:
            fx, fy, nz, _, _ = face_geometry(world, r)
            c = transform_point(world, off)
            geom.append((np.asarray(c, np.float64), nz))
            for sx in (-1.0, 1.0):
                for sy in (-1.0, 1.0):
                    corners.append(c + fx * (sx * r.half_width) + fy * (sy * r.half_height))
        # a closed box has 8 corners, each shared by exactly 3 faces
        pts = np.asarray(corners, np.float64)
        scale = max(1.0, float(np.abs(pts).max()))
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        if not np.all((d2 < (1e-5 * scale) ** 2).sum(1) == 3):
            return None
        used = [False] * 6
        slabs = []
        for i in range(6):
            if used[i]:
                continue
            ci, ni = geom[i]
            pair = next(
                (j for j in range(i + 1, 6)
                 if not used[j] and np.linalg.norm(geom[j][1] + ni) < 1e-5),
                None,
            )
            if pair is None:
                return None
            used[i] = used[pair] = True
            d_i, d_j = float(ni @ ci), float(ni @ geom[pair][0])
            # stored-orientation signs of the lo/hi planes' faces relative
            # to the slab normal: face i is +1, its antiparallel pair -1.
            # The reference's face codes depend on them (front iff
            # dir·m_face < 0) and its own constructor mixes conventions
            # (``cuboid.rs:19-30``: the z-pair points inward, x/y outward).
            if d_i <= d_j:
                slabs.append((ni, d_i, d_j, 1.0, -1.0))
            else:
                slabs.append((ni, d_j, d_i, -1.0, 1.0))
        if len(slabs) != 3:
            return None
        return (
            np.asarray([s[0] for s in slabs], np.float32),
            np.asarray([s[1] for s in slabs], np.float32),
            np.asarray([s[2] for s in slabs], np.float32),
            np.asarray([s[3] for s in slabs], np.float32),
            np.asarray([s[4] for s in slabs], np.float32),
        )

    boxed_cuboids = []  # (ref, world, faces, slabs): rect rows emitted last

    for ref, obj in scene.pairs():
        world = obj.transform.world
        inner = obj.inner
        if isinstance(inner, Sphere):
            m = mat(inner.material)
            sphere_row_of_obj[ref] = len(sph["radius"])
            sph["center"].append(world[:, 3])
            sph["radius"].append(inner.radius)
            sph["mtype"].append(_MATERIAL_CODES[m.kind])
            sph["albedo"].append(m.albedo)
            sph["rough"].append(m.roughness)
            sph["ior"].append(m.ior)
            sph["emitted"].append(_emitted_of(m))
            if inner.volume is not None:
                vol = scene.data[inner.volume].as_volume()
                sph["vol_grid"].append(vol_index[inner.volume])
                sph["vol_size"].append(np.asarray(vol.size, np.float32))
            else:
                sph["vol_grid"].append(-1)
                sph["vol_size"].append(np.zeros(3, np.float32))
        elif isinstance(inner, Rect):
            rect_rows_of_obj[ref] = [len(rct["hw"])]
            add_rect(world, np.zeros(3), inner)
        elif isinstance(inner, Cuboid):
            slabs = box_slabs(world, inner.faces)
            if slabs is not None:
                boxed_cuboids.append((ref, world, inner.faces, slabs))
                continue  # face rects emitted after the traced rows
            rows = []
            for offset, rect in inner.faces:
                rows.append(len(rct["hw"]))
                add_rect(world, offset, rect)
            rect_rows_of_obj[ref] = rows
        # Camera / Empty objects are not hit-testable (``object/mod.rs:178``)

    n_trace_rects = len(rct["hw"])  # box-owned face rows start here
    for ref, world, faces, (bn, bdlo, bdhi, bslo, bshi) in boxed_cuboids:
        rows = []
        for offset, rect in faces:
            rows.append(len(rct["hw"]))
            add_rect(world, offset, rect)
        rect_rows_of_obj[ref] = rows
        m = mat(faces[0][1].material)
        box["n"].append(bn)
        box["dlo"].append(bdlo)
        box["dhi"].append(bdhi)
        box["sgn_lo"].append(bslo)
        box["sgn_hi"].append(bshi)
        box["mtype"].append(_MATERIAL_CODES[m.kind])
        box["albedo"].append(m.albedo)
        box["rough"].append(m.roughness)
        box["ior"].append(m.ior)
        box["emitted"].append(_emitted_of(m))

    # lights
    lights = [(ref, obj) for ref, obj in scene.pairs() if obj.has_flags(ObjectFlags.LIGHT)]
    L = max(1, len(lights))
    F = max(
        [1]
        + [
            len(obj.inner.faces) if isinstance(obj.inner, Cuboid) else 1
            for _, obj in lights
            if isinstance(obj.inner, (Rect, Cuboid))
        ]
    )
    lk = np.zeros(L, np.int32)
    lsc = np.zeros((L, 3), np.float32)
    lsr = np.ones(L, np.float32)
    lfc = np.zeros((L, F, 3), np.float32)
    lfx = np.zeros((L, F, 3), np.float32)
    lfy = np.zeros((L, F, 3), np.float32)
    lfux = np.zeros((L, F, 3), np.float32)
    lfuy = np.zeros((L, F, 3), np.float32)
    lfz = np.tile(np.array([0, 0, 1], np.float32), (L, F, 1))
    lfhw = np.ones((L, F), np.float32)
    lfhh = np.ones((L, F), np.float32)
    lfa = np.ones((L, F), np.float32)
    lcdf = np.ones((L, F), np.float32)
    lval = np.zeros((L, F), bool)
    lsrow = np.full(L, -1, np.int32)
    lrrows = np.full((L, F), -1, np.int32)
    for i, (ref, obj) in enumerate(lights):
        if isinstance(obj.inner, Sphere):
            lk[i] = 0
            lsc[i] = obj.transform.world[:, 3]
            lsr[i] = obj.inner.radius
            lsrow[i] = sphere_row_of_obj[ref]
        else:
            lk[i] = 1
            world = obj.transform.world
            faces = (
                obj.inner.faces
                if isinstance(obj.inner, Cuboid)
                else [(np.zeros(3), obj.inner)]
            )
            areas = np.array([world_area(world, r) for _, r in faces], np.float32)
            cdf = np.cumsum(areas / areas.sum())
            for j, (off, r) in enumerate(faces):
                fx_j, fy_j, nz_j, ux_j, uy_j = face_geometry(world, r)
                lfc[i, j] = transform_point(world, off)
                lfx[i, j] = fx_j
                lfy[i, j] = fy_j
                lfux[i, j] = ux_j
                lfuy[i, j] = uy_j
                lfz[i, j] = nz_j
                lfhw[i, j] = r.half_width
                lfhh[i, j] = r.half_height
                lfa[i, j] = areas[j]
                lcdf[i, j] = cdf[j]
                lval[i, j] = True
                lrrows[i, j] = rect_rows_of_obj[ref][j]
            lcdf[i, len(faces):] = 1.0

    # volumes: pad all grids to a common [D,H,W]
    if vol_keys:
        grids = [scene.data[k].as_volume() for k in vol_keys]
        D = max(g.depth for g in grids)
        H = max(g.height for g in grids)
        W = max(g.width for g in grids)
        vol_grid = np.zeros((len(grids), D, H, W), np.float32)
        for i, g in enumerate(grids):
            vol_grid[i, : g.depth, : g.height, : g.width] = g.grid()
    else:
        vol_grid = np.zeros((1, 1, 1, 1), np.float32)

    # geodesic masses: objects tagged "mass:<schwarzschild_radius>"
    mass_center, mass_rs = [], []
    for ref, obj in scene.pairs():
        if obj.tag and obj.tag.startswith("mass:"):
            mass_center.append(obj.transform.world[:, 3])
            mass_rs.append(float(obj.tag.split(":", 1)[1]))

    root = scene.root_material_data()

    f = lambda x, shape=None: (  # noqa: E731
        np.asarray(x, np.float32).reshape(shape) if shape else np.asarray(x, np.float32)
    )
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731

    Ns = len(sph["radius"])
    Nr = len(rct["hw"])
    host = SceneArrays(
        sph_center=f(sph["center"], (Ns, 3)),
        sph_radius=f(sph["radius"], (Ns,)),
        sph_mtype=i32(sph["mtype"]).reshape(Ns),
        sph_albedo=f(sph["albedo"], (Ns, 3)),
        sph_rough=f(sph["rough"], (Ns,)),
        sph_ior=f(sph["ior"], (Ns,)),
        sph_emitted=f(sph["emitted"], (Ns, 3)),
        sph_vol_grid=i32(sph["vol_grid"]).reshape(Ns),
        sph_vol_size=f(sph["vol_size"], (Ns, 3)),
        rct_center=f(rct["center"], (Nr, 3)),
        rct_x=f(rct["x"], (Nr, 3)),
        rct_y=f(rct["y"], (Nr, 3)),
        rct_z=f(rct["z"], (Nr, 3)),
        rct_fx=f(rct["fx"], (Nr, 3)),
        rct_fy=f(rct["fy"], (Nr, 3)),
        rct_hw=f(rct["hw"], (Nr,)),
        rct_hh=f(rct["hh"], (Nr,)),
        rct_mtype=i32(rct["mtype"]).reshape(Nr),
        rct_albedo=f(rct["albedo"], (Nr, 3)),
        rct_rough=f(rct["rough"], (Nr,)),
        rct_ior=f(rct["ior"], (Nr,)),
        rct_emitted=f(rct["emitted"], (Nr, 3)),
        box_n=f(box["n"], (len(box["rough"]), 3, 3)),
        box_dlo=f(box["dlo"], (len(box["rough"]), 3)),
        box_dhi=f(box["dhi"], (len(box["rough"]), 3)),
        box_sgn_lo=f(box["sgn_lo"], (len(box["rough"]), 3)),
        box_sgn_hi=f(box["sgn_hi"], (len(box["rough"]), 3)),
        box_mtype=i32(box["mtype"]).reshape(len(box["rough"])),
        box_albedo=f(box["albedo"], (len(box["rough"]), 3)),
        box_rough=f(box["rough"], (len(box["rough"]),)),
        box_ior=f(box["ior"], (len(box["rough"]),)),
        box_emitted=f(box["emitted"], (len(box["rough"]), 3)),
        rct_traced=np.arange(n_trace_rects, dtype=np.int32),
        root_mtype=i32(_MATERIAL_CODES[root.kind]),
        root_albedo=f(root.albedo),
        root_emitted=f(_emitted_of(root)),
        light_kind=i32(lk),
        light_sph_center=f(lsc),
        light_sph_radius=f(lsr),
        light_face_center=f(lfc),
        light_face_x=f(lfx),
        light_face_y=f(lfy),
        light_face_ux=f(lfux),
        light_face_uy=f(lfuy),
        light_face_z=f(lfz),
        light_face_hw=f(lfhw),
        light_face_hh=f(lfhh),
        light_face_area=f(lfa),
        light_face_cdf=f(lcdf),
        light_face_valid=np.asarray(lval),
        light_sph_row=i32(lsrow),
        light_rct_rows=i32(lrrows),
        vol_grid=f(vol_grid),
        mass_center=f(np.asarray(mass_center, np.float32).reshape(-1, 3)),
        mass_rs=f(np.asarray(mass_rs, np.float32).reshape(-1)),
    )
    return scene_arrays_from_numpy(host, device)


def scene_arrays_from_numpy(host: SceneArrays, device="cuda") -> SceneArrays:
    """Numpy-leaved tables (this module's or ``bendy_tpu``'s
    ``SceneArrays.host_copy()``) -> the port's :class:`SceneArrays` of
    tensors on ``device`` (the card unless the caller asks for the CPU),
    with the same names, shapes and dtypes. The numpy leaves are kept as
    the host copy."""
    device = resolve_device(device)
    names = [f.name for f in fields(SceneArrays)]
    leaves = {n: np.asarray(getattr(host, n)) for n in names}
    host_np = SceneArrays(**leaves)
    arrays = SceneArrays(**{
        n: torch.from_numpy(np.array(v, copy=True)).to(device)
        for n, v in leaves.items()
    })
    object.__setattr__(arrays, "_host", host_np)
    return arrays


