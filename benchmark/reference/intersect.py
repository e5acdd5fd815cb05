"""Batched, branchless primitive intersection.

Counterpart of ``bendy_tpu/ops/intersect.py``. The nearest hit tests every
primitive row of a kind at once ([N, B] tensors) and takes the first row
that reaches the smallest t, so each lane ends with the winning
primitive's geometry and material; the light pdf reads each lane's own
light row. The plain path of the CUDA tracer (:mod:`.trace_kernel`); the
kernel runs the same sweep per thread, row by row, over the tables in
shared memory.

Face codes (``src/tracer/ray.rs:8-15``):
    0 FRONT, 1 BACK, 2 VOLUME, 3 VOLUME_FRONT, 4 VOLUME_BACK.  MISS = -1.

Formulas:
- sphere: half-b quadratic, near root preferred, far root fallback within
  clip (``src/scene/object/sphere.rs:121-148``),
- rect: plane hit t = ((c-o)·n)/(d·n) with |d·n| <= 1e-5 parallel reject
  and in-plane containment via basis projection
  (``src/scene/object/rect.rs:110-142``); front when (c-o)·n < 0,
- box: three slabs in place of six rect faces, same hits and face codes
  (``src/scene/object/cuboid.rs:83-105``).

The clip ``[cmin, cmax]`` of ``sphere_t``, ``rect_t``, ``box_t`` and
``nearest_hit`` is either two Python floats (flat space) or per-lane [B]
tensors (the geodesic chord clip ``[fresh ? clip_min : 0, near ? |chord| :
clip_max]``, the march clip ``[0, volume_step]``); the compares broadcast,
so both give the same winners.

Volumes (``sphere.rs:71-83,150-166``): a sphere that carries a density
grid reports VOLUME_FRONT/VOLUME_BACK instead of FRONT/BACK, and a
marching lane's last sphere gets an interior VOLUME pseudo-hit at
``t = cmax`` (zero normal) while the march step's end point is still
inside it. The Hit carries the winning sphere's grid, its row and its
bounding box for the density lookup (:mod:`.volume`).

The reference's looped table sweeps (``nearest_hit_looped``,
``light_pdf_looped``, kernel 1e) compute the same winners as its unrolled
ones, bit for bit (``tests/test_looped_sweep.py``); they exist because an
XLA unroll's compile time grows with the count and Mosaic indexes only
SMEM by a traced row. Here the row loop runs at any count, so these
functions serve both configurations.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from .compiler import MAT_EMISSIVE, MAT_FLAT, SceneArrays
from .v3 import V3, sqrt_rn

INF = math.inf

FACE_FRONT = 0
FACE_BACK = 1
FACE_VOLUME = 2
FACE_VOLUME_FRONT = 3
FACE_VOLUME_BACK = 4
FACE_MISS = -1


class Hit(NamedTuple):
    """Nearest-hit record for a batch of lanes, with the winning
    primitive's material baked in."""

    t: torch.Tensor  # [B] distance, +inf on miss
    valid: torch.Tensor  # [B] bool
    position: V3
    normal: V3
    face: torch.Tensor  # [B] int32 face code
    mtype: torch.Tensor  # [B] int32 material code
    albedo: V3  # valid on scattering kinds only: Flat/Emissive winners
    #   carry their *emitted* color here (one merged color per primitive)
    rough: torch.Tensor  # [B]
    ior: torch.Tensor  # [B]
    emitted: V3
    vol_grid: torch.Tensor  # [B] int32 density grid index, -1 = none
    vol_size: V3  # grid (w-1, h-1, d-1) of the winning sphere
    sphere_row: torch.Tensor  # [B] int32 sphere row when a sphere won, else -1
    bbox_min: V3  # the winning sphere's bounding box (volume coordinates)
    bbox_size: V3


def sphere_t(org: V3, dir: V3, cmin, cmax, center: V3, radius) -> torch.Tensor:
    """Hit distance against one sphere, +inf on miss."""
    oc = org - center
    half_b = oc.dot(dir)
    c = oc.length_squared() - radius * radius
    disc = half_b * half_b - c
    sq = sqrt_rn(torch.clamp_min(disc, 0.0))
    t_near = -half_b - sq
    t_far = -half_b + sq
    near_ok = (t_near >= cmin) & (t_near <= cmax)
    far_ok = (t_far >= cmin) & (t_far <= cmax)
    t = torch.where(near_ok, t_near, torch.where(far_ok, t_far, INF))
    return torch.where(disc >= 0.0, t, INF)


def rect_t(org: V3, dir: V3, cmin, cmax, center: V3, xb: V3, yb: V3, zb: V3,
           hw, hh) -> tuple[torch.Tensor, torch.Tensor]:
    """(t, p) against one rect; t=+inf on miss, p = (c-o)·n plane-side sign."""
    q = dir.dot(zb)
    p = (center - org).dot(zb)
    q_safe = torch.where(torch.abs(q) <= 1e-5, 1.0, q)
    t = p / q_safe
    local = org + dir * t - center
    lx = local.dot(xb)
    ly = local.dot(yb)
    ok = (
        (torch.abs(q) > 1e-5)
        & (t >= cmin)
        & (t <= cmax)
        & (lx * lx <= hw * hw)
        & (ly * ly <= hh * hh)
    )
    return torch.where(ok, t, INF), p


def box_t(org: V3, dir: V3, cmin, cmax, bn, bdlo, bdhi, bslo, bshi):
    """(t, p_sign, zb_like) against one three-slab box; t=+inf on miss.

    Slab i admits n_i·(o + t·d) in [dlo_i, dhi_i]; the winner is the entry
    plane (tnear in clip) or else the exit plane. Parallel slabs
    (|d·n| <= 1e-5) pass freely when the origin lies between the planes.
    The face code follows the winning face's stored orientation (baked
    ``bslo``/``bshi`` signs); p_sign < 0 means front, and zb_like is the
    normal the rect manifold expects (it negates it on back faces).
    """
    B = org.x.shape
    dev = org.x.device
    tnear = torch.full(B, -INF, device=dev)
    tfar = torch.full(B, INF, device=dev)
    near_n = V3.zeros(B, dev)
    far_n = V3.zeros(B, dev)
    fr_near = torch.ones(B, device=dev)
    fr_far = torch.ones(B, device=dev)
    for i in range(3):
        n_i = V3(bn[i, 0], bn[i, 1], bn[i, 2])
        q = dir.dot(n_i)
        p = org.dot(n_i)
        par = torch.abs(q) <= 1e-5
        inv = 1.0 / torch.where(par, 1.0, q)
        t1 = (bdlo[i] - p) * inv
        t2 = (bdhi[i] - p) * inv
        tno = torch.minimum(t1, t2)
        tfo = torch.maximum(t1, t2)
        inside = (p >= bdlo[i]) & (p <= bdhi[i])
        # parallel: between the planes -> slab is unbounded, else empty
        tno = torch.where(par, torch.where(inside, -INF, INF), tno)
        tfo = torch.where(par, torch.where(inside, INF, -INF), tfo)
        pos_q = q > 0.0
        oriented = n_i * torch.where(pos_q, -1.0, 1.0)
        # front iff sign(q)·sigma_winning_plane == -1: q>0 enters through
        # the lo plane and exits through hi
        sgn_entry = torch.where(pos_q, bslo[i], -bshi[i])
        sgn_exit = torch.where(pos_q, bshi[i], -bslo[i])
        upd_n = tno > tnear
        upd_f = tfo < tfar
        tnear = torch.where(upd_n, tno, tnear)
        near_n = V3.where(upd_n, oriented, near_n)
        fr_near = torch.where(upd_n, sgn_entry, fr_near)
        tfar = torch.where(upd_f, tfo, tfar)
        far_n = V3.where(upd_f, oriented, far_n)
        fr_far = torch.where(upd_f, sgn_exit, fr_far)
    nonempty = tnear <= tfar
    near_ok = nonempty & (tnear >= cmin) & (tnear <= cmax)
    far_ok = nonempty & (tfar >= cmin) & (tfar <= cmax)
    t = torch.where(near_ok, tnear, torch.where(far_ok, tfar, INF))
    p_sign = torch.where(near_ok, fr_near, fr_far)  # <0 = front
    winning_n = V3.where(near_ok, near_n, far_n)
    zb_like = winning_n * (-p_sign)
    return t, p_sign, zb_like


def _color_rows(mtype: torch.Tensor, albedo: torch.Tensor,
                emitted: torch.Tensor) -> torch.Tensor:
    """The one rgb per primitive row [N,3] that shading can read:
    ``emitted`` for the terminating kinds (Flat, Emissive), ``albedo`` for
    scattering kinds."""
    is_em = (mtype == MAT_FLAT) | (mtype == MAT_EMISSIVE)
    return torch.where(is_em[:, None], emitted, albedo)


def _rows(a: torch.Tensor) -> V3:
    """An [N,3] table as a V3 of [N,1] columns, which broadcast against
    [B] lanes to [N,B]."""
    return V3(a[:, 0, None], a[:, 1, None], a[:, 2, None])


def nearest_hit(org: V3, dir: V3, cmin, cmax, scn: SceneArrays,
                march: torch.Tensor | None = None,
                last_sphere: torch.Tensor | None = None,
                carry_volumes: bool = True) -> Hit:
    """Nearest hit across all primitives for each lane: spheres, then the
    traced rects, then boxes, a later primitive replacing the winner only
    on a strictly smaller t.

    Every primitive of a kind is tested at once ([N, B] tensors: each
    element rounds as the per-row test would) and the winner is the first
    row that reaches the smallest t, which is what the row loop of the
    kernel (and of the reference's sweeps) picks; a NaN t never wins. The
    winner's attributes are gathered by its row. Attributes that only some
    winners set keep the row loop's values: the sphere box (``c_center``,
    ``c_radius``, ``vol_size``) is the nearest sphere's even when a rect
    or box wins, the rect normal is zero when a sphere wins.

    With ``march`` lanes ([B] bool) and their ``last_sphere`` rows, the
    last sphere of a marching lane gets the volumetric treatment: if the
    point at ``t = cmax`` is still inside it (``|end - center|² <= r²``),
    an interior VOLUME event at ``cmax`` replaces that sphere's surface
    test. ``carry_volumes=False`` (a scene without grids) drops the grid
    carries; the Hit then reports no grid.
    """
    B = org.x.shape
    dev = org.x.device
    zero = torch.zeros(B, device=dev)
    ns, nt, nb = scn.n_spheres, scn.n_trace_rects, scn.n_boxes
    has_sph = ns > 0
    has_rct = nt > 0 or nb > 0

    ts, zbs, ps = [], [], []
    mtypes, colors, roughs, iors = [], [], [], []
    if ns:
        center, radius = _rows(scn.sph_center), scn.sph_radius[:, None]
        t_s = sphere_t(org, dir, cmin, cmax, center, radius)
        if march is not None:
            rows = torch.arange(ns, device=dev)[:, None]
            is_last = march & (last_sphere == rows)
            end = org + dir * cmax
            inside = (end - center).length_squared() <= radius * radius
            t_s = torch.where(is_last, torch.where(inside, cmax, t_s), t_s)
        ts.append(t_s)
        zbs.append(V3.zeros((ns, *B), dev))
        ps.append(torch.zeros((ns, *B), device=dev))
        mtypes.append(scn.sph_mtype)
        colors.append(_color_rows(scn.sph_mtype, scn.sph_albedo, scn.sph_emitted))
        roughs.append(scn.sph_rough)
        iors.append(scn.sph_ior)
    if nt:
        r = slice(0, nt)
        zb = _rows(scn.rct_z[r])
        t_r, p_r = rect_t(org, dir, cmin, cmax, _rows(scn.rct_center[r]), _rows(scn.rct_x[r]),
                          _rows(scn.rct_y[r]), zb, scn.rct_hw[r, None], scn.rct_hh[r, None])
        ts.append(t_r)
        zbs.append(zb + V3.zeros((nt, *B), dev))
        ps.append(p_r)
        mtypes.append(scn.rct_mtype[r])
        colors.append(_color_rows(scn.rct_mtype[r], scn.rct_albedo[r], scn.rct_emitted[r]))
        roughs.append(scn.rct_rough[r])
        iors.append(scn.rct_ior[r])
    if nb:
        col = lambda a: a.T[..., None]  # noqa: E731  [Nb,3] -> [3,Nb,1]
        t_b, p_b, zb_b = box_t(org, dir, cmin, cmax, scn.box_n.permute(1, 2, 0)[..., None],
                               col(scn.box_dlo), col(scn.box_dhi), col(scn.box_sgn_lo),
                               col(scn.box_sgn_hi))
        ts.append(t_b)
        zbs.append(zb_b)
        ps.append(p_b)
        mtypes.append(scn.box_mtype)
        colors.append(_color_rows(scn.box_mtype, scn.box_albedo, scn.box_emitted))
        roughs.append(scn.box_rough)
        iors.append(scn.box_ior)

    if not ts:  # no primitive: one row that every lane misses
        ts.append((zero + INF)[None])
        zbs.append(V3.zeros((1, *B), dev))
        ps.append(zero[None])
        mtypes.append(torch.zeros(1, dtype=torch.int32, device=dev))
        colors.append(torch.zeros((1, 3), device=dev))
        roughs.append(torch.zeros(1, device=dev))
        iors.append(torch.ones(1, device=dev))
    t_all = torch.cat(ts)
    t_all = torch.where(torch.isnan(t_all), INF, t_all)
    win = t_all.argmin(dim=0)
    t_best = t_all.gather(0, win[None])[0]
    valid = torch.isfinite(t_best)
    is_sph = valid & (win < ns)
    lane = torch.arange(win.shape[0], device=dev)

    def winner(a: torch.Tensor, fill):
        """The winning row's value of an [N] table, ``fill`` on misses."""
        return torch.where(valid, a[win], fill)

    c_mtype = winner(torch.cat(mtypes), 0).to(torch.int32)
    c_color = V3.from_array(torch.where(valid[:, None], torch.cat(colors)[win], 0.0))
    c_rough = winner(torch.cat(roughs), 0.0)
    c_ior = winner(torch.cat(iors), 1.0)
    surf_rect = valid & ~is_sph
    zb_all = V3(*(torch.cat([z[i] for z in zbs]) for i in range(3)))
    c_zb = V3(*(torch.where(surf_rect, c[win, lane], 0.0) for c in zb_all))
    c_p = torch.where(surf_rect, torch.cat(ps)[win, lane], 0.0)

    srow = torch.full(B, -1, dtype=torch.int64, device=dev)
    interior = torch.zeros(B, dtype=torch.bool, device=dev)
    c_vgrid = torch.full(B, -1, dtype=torch.int32, device=dev)
    c_center, c_radius, c_vsize = V3(zero, zero, zero), zero + 1.0, V3(zero, zero, zero)
    if ns:
        # the nearest sphere: the carry the row loop leaves after the spheres
        w_s = t_all[:ns].argmin(dim=0)
        hit_s = torch.isfinite(t_all[:ns].gather(0, w_s[None])[0])
        srow = torch.where(hit_s, w_s, -1)
        c_center = V3(*(torch.where(hit_s, scn.sph_center[:, i][w_s], 0.0)
                        for i in range(3)))
        c_radius = torch.where(hit_s, scn.sph_radius[w_s], 1.0)
        if carry_volumes:
            c_vsize = V3(*(torch.where(hit_s, scn.sph_vol_size[:, i][w_s], 0.0)
                           for i in range(3)))
            c_vgrid = torch.where(is_sph, scn.sph_vol_grid[w_s], -1).to(torch.int32)
        if march is not None:
            interior = is_sph & (is_last & inside)[w_s, lane]

    return _manifold(org, dir, t_best, is_sph, srow, interior, c_center, c_radius,
                     c_zb, c_p, c_mtype, c_color, c_rough, c_ior, c_vgrid, c_vsize,
                     has_sph, has_rct)


def _manifold(org: V3, dir: V3, t_best, is_sph, srow, interior, c_center, c_radius,
              c_zb, c_p, c_mtype, c_color, c_rough, c_ior, c_vgrid, c_vsize,
              has_sph: bool, has_rct: bool) -> Hit:
    """Winner carries -> Hit record: face codes, oriented normals, the
    interior pseudo-hit, the (albedo, emitted) split of the merged color
    carry, and the winning sphere's grid, row and bounding box."""
    B = org.x.shape
    dev = org.x.device
    valid = torch.isfinite(t_best)
    position = org + dir * t_best
    miss = torch.full(B, FACE_MISS, dtype=torch.int32, device=dev)
    normal = V3.zeros(B, dev)
    face = miss

    if has_rct:
        # rect manifold (``rect.rs:138-142``)
        r_front = c_p < 0.0
        normal = V3.where(r_front, c_zb, -c_zb)
        face = torch.where(valid, torch.where(r_front, FACE_FRONT, FACE_BACK), miss)
    if has_sph:
        # sphere manifold (``sphere.rs:85-119``)
        s_normal = (position - c_center) / c_radius
        s_front = dir.dot(s_normal) < 0.0
        s_normal = V3.where(s_front, s_normal, -s_normal)
        s_face = torch.where(
            c_vgrid >= 0,
            torch.where(s_front, FACE_VOLUME_FRONT, FACE_VOLUME_BACK),
            torch.where(s_front, FACE_FRONT, FACE_BACK),
        )
        # interior pseudo-hit: zero normal, VOLUME face (``sphere.rs:71-83``)
        s_normal = V3.where(interior, V3.zeros(B, dev), s_normal)
        s_face = torch.where(interior, FACE_VOLUME, s_face)
        normal = V3.where(is_sph, s_normal, normal) if has_rct else s_normal
        face = torch.where(valid & (is_sph | (not has_rct)), s_face, face)
    face = face.to(torch.int32)

    # emitted is the merged color for terminating kinds and zero for
    # scattering kinds; albedo is only read on scattering lanes
    emitting = ((c_mtype == MAT_FLAT) | (c_mtype == MAT_EMISSIVE)).to(torch.get_default_dtype())
    return Hit(
        t=t_best,
        valid=valid,
        position=position,
        normal=normal,
        face=face,
        mtype=c_mtype,
        albedo=c_color,
        rough=c_rough,
        ior=c_ior,
        emitted=c_color * emitting,
        vol_grid=torch.where(is_sph, c_vgrid, -1).to(torch.int32),
        vol_size=c_vsize,
        sphere_row=torch.where(is_sph & valid, srow, -1).to(torch.int32),
        bbox_min=c_center - c_radius,
        bbox_size=V3.zeros(B, dev) + 2.0 * c_radius,
    )


def light_pdf(org: V3, dir: V3, cmin, cmax, scn: SceneArrays,
              light_idx: torch.Tensor) -> torch.Tensor:
    """Area-form pdf of direction ``dir`` toward light ``light_idx``.

    Matches ``light_pdf`` (``src/scene/data/material.rs:313-316``) and the
    per-shape pdfs: sphere t²/(πr²) (``sphere.rs:44-61``), rect
    t²/(area·|d·n|) (``rect.rs:92-108``), cuboid = nearest valid face's pdf
    (``cuboid.rs:56-81``); 0 when the ray misses the light. Each lane reads
    its own light's row, so the cost does not grow with the light count,
    and the sweep over faces keeps the kernel's order.
    """
    B = org.x.shape
    dev = org.x.device
    if scn.n_lights == 0:
        return torch.zeros(B, device=dev)
    li = light_idx.long()
    r = scn.light_sph_radius[li]
    t_s = sphere_t(org, dir, cmin, cmax, V3.from_array(scn.light_sph_center[li]), r)
    pdf_s = torch.where(torch.isfinite(t_s), t_s * t_s / (math.pi * r * r), 0.0)
    t_b = torch.full(B, INF, device=dev)
    q_b = torch.ones(B, device=dev)
    area_b = torch.ones(B, device=dev)
    for f in range(scn.light_face_cdf.shape[1]):
        zb = V3.from_array(scn.light_face_z[li, f])
        # containment bases are the inverse-transposed ones
        t_f, _ = rect_t(
            org, dir, cmin, cmax, V3.from_array(scn.light_face_center[li, f]),
            V3.from_array(scn.light_face_ux[li, f]), V3.from_array(scn.light_face_uy[li, f]),
            zb, scn.light_face_hw[li, f], scn.light_face_hh[li, f],
        )
        better = scn.light_face_valid[li, f] & (t_f < t_b)
        t_b = torch.where(better, t_f, t_b)
        q_b = torch.where(better, dir.dot(zb), q_b)
        area_b = torch.where(better, scn.light_face_area[li, f], area_b)
    pdf_r = torch.where(torch.isfinite(t_b), t_b * t_b / (area_b * torch.abs(q_b)), 0.0)
    return torch.where(scn.light_kind[li] == 0, pdf_s, pdf_r)
