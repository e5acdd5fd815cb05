"""A bounding-volume hierarchy over the scene table's primitives, and its
plain walk.

The looped primitive sweep (kernel 1e-i, ``bendy_tpu/ops/intersect.py:740``
``nearest_hit_looped``) tests every sphere, traced rect and box on every
segment. The reference tried to cull it on a v5e with one bounding sphere
per 8-row block and a block-wide any-reduce, and the cull lost 17-28 %: a
2,048-lane block nearly always holds one lane whose segment reaches every
block. A Hopper thread skips a subtree on its own, so the CUDA tracer's
instantiations for scenes past ``render.LOOP_SWEEP_THRESHOLD`` walk this
tree instead (``csrc/trace_surface.cu``, ``nearest_hit_bvh``): a 0.1-long
march step overlaps a handful of leaves, not 258 rows.

The contract is the sweep's nearest hit, bit for bit: every primitive's t
comes from the same ``sphere_t`` / ``rect_t`` / ``box_t`` with the lane's
own clip, and a candidate wins on ``t < t_best || (t == t_best && key <
key_best)``, the lexicographic least (t, key) over every primitive. That
is the sweep's "first row with the smallest t" (keys follow the sweep's
order: sphere rows, then ``n_sph`` + rect rows, then ``n_sph + n_rct`` +
box rows), it does not depend on the order of the walk, and a NaN t never
wins. The tree only decides which primitives are tested, so a node may be
skipped only if no primitive under it can report a t in ``[cmin, min(cmax,
t_best)]``.

Conservative bounds. A node's box is the union, in float64, of its
members' exact boxes (a sphere's center ± radius; a rect's or box's
corners solved from the table's own f32 bases), rounded outward to f32. A
primitive's f32 test can report a t whose point ``org + dir·t`` lies
outside that box, so the walk pads every node box by a per-ray distance
``pad`` (``ray_setup``, ``pad_for``), from an error bound of the f32
tests (no multiply-add contraction, IEEE division and sqrt):

- a sphere: ``|P - c|² <= r² + (59u + ε)(r + t)²`` with u = 2^-24 and
  ε = | |dir|² - 1 |: the half-b quadratic assumes a unit direction, and
  the port's directions are not (its polynomial sin/cos leave |dir|² up to
  3e-5 off 1 on scattered rays), so a sphere "hits" rays that pass up to
  ``sqrt(ε)·t`` outside it, as the sweep does. The pad takes ``s·(r_max +
  T)`` with ``s = sqrt(1.2e-5 + 3(ε + 4u))`` (at least 1.4 times the
  bound; seeded grazing rays reach 0.58 of it from ε and 0.22 from
  rounding), T = the least of ``min(cmax, t_best)`` and the farthest any
  member can be from the origin;
- rects and boxes: slab coordinates off by at most ``6u(|org|₁ + mag +
  T)`` and, on a slab the box test takes as parallel (|d·n| <= 1e-5), by
  ``1e-5·T``; mapped to space by ``κ``, the ∞-norm condition number of the
  three slab rows. Primitives with κ > ``KAPPA_MAX``, a singular basis or
  a non-finite value go to the always-tested list;
- the node test's own slab arithmetic: ``3u|lo - org|`` per plane.

Huge primitives, those whose box diagonal exceeds ``ALWAYS_FRAC`` of the
diagonal of all finite primitive boxes (prim_grid's and light_field's
ground rects, scene.json's r = 100 ground sphere, cornell's walls), are
not in the tree either: every segment would enter their nodes, and their
size would set the scene magnitude every pad is scaled by. They are swept
first, as the sweep does, before the walk.

The node block (``build_bvh``) is one flat f32 array, appended to the
scene table after the mass block, so no earlier offset moves:

    header [16]: n_node, n_always, has_spheres, r_max, k_rb, c_abs, mag,
                 r_t, center xyz, 0 x5
    nodes [n_node, 8]: lo xyz, hi xyz, then an inner node's right child
                 and -1, or a leaf's first key and count (>= 1); the left
                 child follows its parent (preorder)
    keys [n_key]: the always-tested keys, then the leaves' keys

Indices are exact small floats, as the table stores ``mtype``.
:func:`nearest_hit_bvh_plain` is the plain PyTorch walk of the same
layout, in the kernel's f32 operations and order, so its per-lane node and
primitive test counts equal the kernel's; the CPU tracer does not call it
(its route is the sweep, whose image is the contract); tests and
``chip_smoke.py`` phase 3 do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bendy_tpu_torch.ops.intersect import (
    INF,
    Hit,
    _color_rows,
    _manifold,
    box_t,
    rect_t,
    sphere_t,
)
from bendy_tpu_torch.scene.compiler import SceneArrays
from bendy_tpu_torch.utils.v3 import V3, sqrt_rn

# the table's column counts (ops/trace_kernel.scene_table)
SPH_COLS, RCT_COLS, BOX_COLS = 15, 21, 28

BVH_HEAD = 16  # header floats
BVH_NODE = 8  # floats per node
BVH_STACK = 16  # the kernel's walk stack, uint16 entries per thread: the deepest tree
MAX_NODES = 1 << 16  # node indices fit the uint16 stack
LEAF_MAX = 4  # primitives per leaf
SAH_MIN = 16  # nodes of at most this many primitives split at the median, not by the SAH
ALWAYS_FRAC = 0.5  # box diagonal over the scene's above which a primitive is always tested
KAPPA_MAX = 64.0  # slab-row condition number above which a primitive is always tested

# header slots
H_NODES, H_ALWAYS, H_SPH, H_RMAX, H_KRB, H_CABS, H_MAG, H_RT, H_CENTER = range(9)

U = 2.0**-24  # f32 unit roundoff
# the sphere pad's multiplier s = sqrt(S0 + (|dir|² - 1| + E4U)·3) and the
# largest s for which the farthest-member bound on t holds
S0, E4U, S_MAX = 1.2e-5, 4 * U, 0.01
T_GROWTH = 1.02  # t <= (|org - center|₁ + r_t + q)·1.02 while s <= S_MAX


def _inv3(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverses of [N,3,3] float64 matrices by the adjugate, and whether
    each is usable (finite with a nonzero determinant)."""
    a, b, c = m[:, 0], m[:, 1], m[:, 2]
    cof = np.stack([np.cross(b, c), np.cross(c, a), np.cross(a, b)], axis=1)  # rows of adj^T
    det = np.einsum("ij,ij->i", a, cof[:, 0])
    ok = np.isfinite(det) & (det != 0.0) & np.isfinite(m).all(axis=(1, 2))
    inv = np.transpose(cof, (0, 2, 1)) / np.where(ok, det, 1.0)[:, None, None]
    return inv, ok & np.isfinite(inv).all(axis=(1, 2))


def _slab_boxes(rows: np.ndarray, b_lo: np.ndarray, b_hi: np.ndarray, origin: np.ndarray):
    """(lo, hi [N,3], κ [N], usable [N]) of the parallelepipeds
    {x : rows_i·(x - origin) in [b_lo_i, b_hi_i]}: the AABB of the eight
    corners, and the ∞-norm condition number of the rows."""
    inv, ok = _inv3(rows)
    signs = np.array([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)], np.float64)
    rhs = b_lo[:, None, :] + signs[None] * (b_hi - b_lo)[:, None, :]  # [N,8,3]
    corners = origin[:, None, :] + np.einsum("nij,nkj->nki", inv, rhs)
    kappa = np.abs(inv).sum(axis=2).max(axis=1) * np.abs(rows).sum(axis=2).max(axis=1)
    ok = ok & np.isfinite(corners).all(axis=(1, 2)) & np.isfinite(kappa)
    return corners.min(axis=1), corners.max(axis=1), kappa, ok


def prim_boxes(sph: np.ndarray, rct: np.ndarray, box: np.ndarray):
    """Each primitive's exact box from the table's f32 rows, in float64:
    (lo, hi [N,3], κ [N] (0 for spheres), usable [N], radius [N] (0 for
    rects and boxes)), N = n_sph + n_rct + n_box in key order."""
    s = np.asarray(sph, np.float64).reshape(-1, SPH_COLS)
    r = np.asarray(rct, np.float64).reshape(-1, RCT_COLS)
    b = np.asarray(box, np.float64).reshape(-1, BOX_COLS)
    rad = np.abs(s[:, 3])
    s_lo, s_hi = s[:, 0:3] - rad[:, None], s[:, 0:3] + rad[:, None]
    s_ok = np.isfinite(s[:, 0:4]).all(axis=1)
    # rect: (p - c)·x in [-hw, hw], (p - c)·y in [-hh, hh], (p - c)·z = 0
    hw, hh = np.abs(r[:, 12]), np.abs(r[:, 13])
    zero = np.zeros_like(hw)
    r_lo, r_hi, r_k, r_ok = _slab_boxes(
        np.stack([r[:, 3:6], r[:, 6:9], r[:, 9:12]], axis=1),
        np.stack([-hw, -hh, zero], axis=1), np.stack([hw, hh, zero], axis=1), r[:, 0:3])
    # box: n_i·p in [dlo_i, dhi_i]
    b_lo, b_hi, b_k, b_ok = _slab_boxes(b[:, 0:9].reshape(-1, 3, 3), b[:, 9:12], b[:, 12:15],
                                        np.zeros((len(b), 3)))
    lo = np.concatenate([s_lo, r_lo, b_lo])
    hi = np.concatenate([s_hi, r_hi, b_hi])
    kappa = np.concatenate([np.zeros(len(s)), r_k, b_k])
    ok = np.concatenate([s_ok, r_ok, b_ok]) & np.isfinite(np.concatenate([lo, hi], 1)).all(1)
    radius = np.concatenate([rad, np.zeros(len(r) + len(b))])
    return lo, hi, kappa, ok, radius


def _round_out(lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """float64 bounds -> f32 bounds that contain them."""
    lo32, hi32 = lo.astype(np.float32), hi.astype(np.float32)
    lo32 = np.where(lo32.astype(np.float64) > lo, np.nextafter(lo32, np.float32(-np.inf)), lo32)
    hi32 = np.where(hi32.astype(np.float64) < hi, np.nextafter(hi32, np.float32(np.inf)), hi32)
    return lo32, hi32


def _up(x: float) -> np.float32:
    """The least f32 not below ``x``."""
    v = np.float32(x)
    return np.nextafter(v, np.float32(np.inf)) if float(v) < x else v


def _area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = hi - lo
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def _sah_split(lo: np.ndarray, hi: np.ndarray) -> int:
    """The split of boxes sorted along an axis that minimises the surface
    area heuristic, area(left)·|left| + area(right)·|right|."""
    n = len(lo)
    left = _area(np.minimum.accumulate(lo), np.maximum.accumulate(hi))[:-1]
    right = _area(np.minimum.accumulate(lo[::-1]), np.maximum.accumulate(hi[::-1]))[::-1][1:]
    i = np.arange(1, n)
    return int(np.argmin(left * i + right * (n - i))) + 1


def build_bvh(sph: np.ndarray, rct: np.ndarray, box: np.ndarray) -> np.ndarray:
    """The three primitive blocks of ``scene_table`` -> the flat f32 node
    block (layout in the module docstring).

    Primitives whose box is huge, ill-conditioned or not finite are always
    tested; the rest are sorted by centroid along the longest axis of
    their centroids' bounds and split where the surface area heuristic is
    least (at the median in nodes of at most ``SAH_MIN``), down to
    ``LEAF_MAX`` per leaf. A tree deeper than the kernel's stack is built
    again with median splits only (depth about log2(n / LEAF_MAX)); raises
    if that does not fit the stack or the node indices either."""
    lo, hi, kappa, ok, radius = prim_boxes(sph, rct, box)
    n_sph = np.asarray(sph).size // SPH_COLS
    n = len(lo)
    keys_all = np.arange(n)
    diag = np.where(ok, np.linalg.norm(hi - lo, axis=1), np.inf)
    if ok.any():
        scene_diag = float(np.linalg.norm(hi[ok].max(axis=0) - lo[ok].min(axis=0)))
    else:
        scene_diag = 0.0
    in_tree = ok & (diag <= ALWAYS_FRAC * scene_diag) & (kappa <= KAPPA_MAX)
    always = keys_all[~in_tree]
    members = keys_all[in_tree]

    nodes: list = []
    leaf_keys: list = []
    cent = (lo + hi) * 0.5
    depth = 0

    def build(ids: np.ndarray, level: int) -> int:
        nonlocal depth
        depth = max(depth, level)
        idx = len(nodes)
        nodes.append(None)
        b_lo, b_hi = lo[ids].min(axis=0), hi[ids].max(axis=0)
        if len(ids) <= LEAF_MAX:
            nodes[idx] = (b_lo, b_hi, len(always) + len(leaf_keys), len(ids))
            leaf_keys.extend(np.sort(ids).tolist())
            return idx
        c = cent[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        sah = use_sah and len(ids) > SAH_MIN
        mid = _sah_split(lo[ids[order]], hi[ids[order]]) if sah else len(ids) // 2
        build(ids[order[:mid]], level + 1)
        right = build(ids[order[mid:]], level + 1)
        nodes[idx] = (b_lo, b_hi, right, -1)
        return idx

    use_sah = True
    if len(members):
        build(members, 1)
        if depth > BVH_STACK:
            use_sah, depth = False, 0
            nodes.clear()
            leaf_keys.clear()
            build(members, 1)
    if depth > BVH_STACK or len(nodes) >= MAX_NODES:
        raise ValueError(f"BVH of {len(members)} primitives: depth {depth}, {len(nodes)} nodes; "
                         f"the kernel takes depth <= {BVH_STACK} and < {MAX_NODES} nodes")

    head = np.zeros(BVH_HEAD, np.float32)
    block = [head]
    head[H_NODES], head[H_ALWAYS] = len(nodes), len(always)
    if len(nodes):
        n_lo = np.stack([nd[0] for nd in nodes])
        n_hi = np.stack([nd[1] for nd in nodes])
        f_lo, f_hi = _round_out(n_lo, n_hi)
        rest = np.array([[nd[2], nd[3]] for nd in nodes], np.float32)
        block.append(np.concatenate([f_lo, f_hi, rest], axis=1).reshape(-1))
        m_lo, m_hi = lo[members], hi[members]
        center = ((m_lo.min(axis=0) + m_hi.max(axis=0)) * 0.5).astype(np.float32)
        corners = np.stack([np.where(np.array([i >> 2 & 1, i >> 1 & 1, i & 1], bool), m_hi, m_lo)
                            for i in range(8)])
        r_scene = float(np.linalg.norm(corners - center.astype(np.float64), axis=2).max())
        sph_members = members[members < n_sph]
        r_max = float(radius[sph_members].max()) if len(sph_members) else 0.0
        k_max = float(kappa[members].max())
        head[H_SPH] = 1.0 if len(sph_members) else 0.0
        head[H_RMAX] = _up(r_max)
        head[H_KRB] = _up(k_max * (16 * U + 2e-5))
        head[H_CABS] = _up(16 * U * max(k_max, 1.0))
        head[H_MAG] = _up(float(np.abs(np.concatenate([f_lo, f_hi])).max()))
        head[H_RT] = _up(r_scene * (1 + 1e-6) + S_MAX * r_max)
        head[H_CENTER:H_CENTER + 3] = center
    block.append(np.concatenate([always, np.asarray(leaf_keys, np.int64)]).astype(np.float32))
    return np.concatenate(block)


def bvh_counts(block: np.ndarray) -> dict:
    """n_node and n_key of a node block."""
    n_node = int(block[H_NODES])
    return dict(n_node=n_node, n_key=block.size - BVH_HEAD - BVH_NODE * n_node)


class BvhTables(NamedTuple):
    """A node block as tensors on one device, for :func:`nearest_hit_bvh_plain`."""

    head: torch.Tensor  # [BVH_HEAD] f32
    nodes: torch.Tensor  # [n_node, 8] f32
    keys: torch.Tensor  # [n_key] int64
    n_node: int
    n_always: int


def bvh_tables(block: np.ndarray, device) -> BvhTables:
    c = bvh_counts(block)
    head = torch.from_numpy(np.ascontiguousarray(block[:BVH_HEAD])).to(device)
    end = BVH_HEAD + BVH_NODE * c["n_node"]
    nodes = torch.from_numpy(np.ascontiguousarray(block[BVH_HEAD:end])).view(-1, BVH_NODE)
    keys = torch.from_numpy(block[end:].astype(np.int64))
    return BvhTables(head, nodes.to(device), keys.to(device), c["n_node"], int(block[H_ALWAYS]))


class BvhHit(NamedTuple):
    hit: Hit
    key: torch.Tensor  # [B] int64 winning primitive key, -1 on a miss
    node_tests: torch.Tensor  # [B] int64 node boxes tested
    prim_tests: torch.Tensor  # [B] int64 primitive tests (the winner's manifold not counted)


def _prim_t(org: V3, dir: V3, cmin, cmax, scn: SceneArrays, key: torch.Tensor):
    """Each lane's t against primitive ``key`` ([B] int64, in range), as the
    kernel's ``bvh_prim_t``; with the rect or box manifold carries (p, zb)."""
    ns, nt = scn.n_spheres, scn.n_trace_rects
    B = key.shape
    dev = key.device
    t = torch.full(B, INF, device=dev)
    p = torch.zeros(B, device=dev)
    zb = V3.zeros(B, dev)
    if ns:
        k = key.clamp(0, ns - 1)
        t_s = sphere_t(org, dir, cmin, cmax, V3.from_array(scn.sph_center[k]), scn.sph_radius[k])
        t = torch.where(key < ns, t_s, t)
    if nt:
        k = (key - ns).clamp(0, nt - 1)
        z = V3.from_array(scn.rct_z[k])
        t_r, p_r = rect_t(org, dir, cmin, cmax, V3.from_array(scn.rct_center[k]),
                          V3.from_array(scn.rct_x[k]), V3.from_array(scn.rct_y[k]), z,
                          scn.rct_hw[k], scn.rct_hh[k])
        is_r = (key >= ns) & (key < ns + nt)
        t, p, zb = torch.where(is_r, t_r, t), torch.where(is_r, p_r, p), V3.where(is_r, z, zb)
    if scn.n_boxes:
        k = (key - ns - nt).clamp(0, scn.n_boxes - 1)
        t_b, p_b, zb_b = box_t(org, dir, cmin, cmax, scn.box_n[k].permute(1, 2, 0),
                               scn.box_dlo[k].T, scn.box_dhi[k].T, scn.box_sgn_lo[k].T,
                               scn.box_sgn_hi[k].T)
        is_b = key >= ns + nt
        t, p, zb = torch.where(is_b, t_b, t), torch.where(is_b, p_b, p), V3.where(is_b, zb_b, zb)
    return t, p, zb


def ray_setup(org: V3, dir: V3, head: torch.Tensor):
    """Per-ray constants of the walk (the kernel's ``BvhRay``): the inverse
    direction, ``pad(T) = pad0 + pad1·T`` and the bound ``t_a`` on any
    member's t, in the kernel's f32 operations."""
    inv = V3(1.0 / dir.x, 1.0 / dir.y, 1.0 / dir.z)
    dd = dir.dot(dir)
    s = torch.where(head[H_SPH] != 0.0, sqrt_rn(S0 + ((dd - 1.0).abs() + E4U) * 3.0),
                    torch.zeros_like(dd))
    absorg = (org.x.abs() + org.y.abs()) + org.z.abs()
    dist = ((org.x - head[H_CENTER]).abs() + (org.y - head[H_CENTER + 1]).abs()) \
        + (org.z - head[H_CENTER + 2]).abs()
    q = head[H_CABS] * (absorg + head[H_MAG])
    pad0 = s * head[H_RMAX] + q
    pad1 = s + head[H_KRB]
    t_a = torch.where(s <= S_MAX, (dist + (head[H_RT] + q)) * T_GROWTH, INF)
    return inv, pad0, pad1, t_a


def pad_for(inv: V3, pad0, pad1, t_a, tlim) -> V3:
    """The node pad in t along each axis for a search up to ``tlim``."""
    pad = pad0 + pad1 * torch.fmin(tlim, t_a)
    return V3(pad * inv.x.abs(), pad * inv.y.abs(), pad * inv.z.abs())


def node_visit(nd: torch.Tensor, org: V3, inv: V3, tp: V3, cmin, tlim):
    """(whether the padded node boxes ``nd`` [B,8] meet each ray on [cmin,
    tlim], the entry t) as the kernel's ``bvh_node``."""
    t0 = [(nd[:, i] - o) * v for i, o, v in zip(range(3), org, inv)]
    t1 = [(nd[:, 3 + i] - o) * v for i, o, v in zip(range(3), org, inv)]
    tn = torch.fmax(torch.fmax(torch.fmin(t0[0], t1[0]) - tp.x, torch.fmin(t0[1], t1[1]) - tp.y),
                    torch.fmin(t0[2], t1[2]) - tp.z)
    tf = torch.fmin(torch.fmin(torch.fmax(t0[0], t1[0]) + tp.x, torch.fmax(t0[1], t1[1]) + tp.y),
                    torch.fmax(t0[2], t1[2]) + tp.z)
    return ~((tn > torch.fmin(tf, tlim)) | (tf < cmin)), tn


def nearest_hit_bvh_plain(org: V3, dir: V3, cmin, cmax, scn: SceneArrays, bvh: BvhTables,
                          march: torch.Tensor | None = None,
                          last_sphere: torch.Tensor | None = None,
                          carry_volumes: bool = True,
                          active: torch.Tensor | None = None) -> BvhHit:
    """The kernel's ``nearest_hit_bvh`` for a batch of lanes: the march
    pseudo-hit of a lane's last sphere first (outside any culling), then
    the always-tested keys, then the walk (at an inner node both children's
    boxes, the one entered first visited first and the other pushed; a
    popped node's box tested again), each lane with its own stack, in the
    kernel's order and f32 arithmetic. Lanes outside
    ``active`` walk nothing and miss. Returns the same Hit as
    :func:`bendy_tpu_torch.ops.intersect.nearest_hit` on the sweep (the
    winner's attributes; a rect or box winner's manifold recomputed from
    its key, as the kernel does), with the winning key and the per-lane
    node and primitive test counts."""
    B = org.x.shape
    dev = org.x.device
    ns, nt, nb = scn.n_spheres, scn.n_trace_rects, scn.n_boxes
    live0 = torch.ones(B, dtype=torch.bool, device=dev) if active is None else active
    cmin = torch.zeros(B, device=dev) + cmin
    cmax = torch.zeros(B, device=dev) + cmax
    t_best = torch.full(B, INF, device=dev)
    k_best = torch.full(B, -1, dtype=torch.int64, device=dev)
    node_tests = torch.zeros(B, dtype=torch.int64, device=dev)
    prim_tests = torch.zeros(B, dtype=torch.int64, device=dev)
    skip_last = (march & live0) if march is not None else torch.zeros_like(live0)
    last = last_sphere.long() if march is not None else torch.full(B, -1, device=dev)

    def consider(key: torch.Tensor, mask: torch.Tensor) -> None:
        nonlocal t_best, k_best
        t, _, _ = _prim_t(org, dir, cmin, cmax, scn, key.clamp(0, ns + nt + nb - 1))
        win = mask & ((t < t_best) | ((t == t_best) & (key < k_best)))
        t_best = torch.where(win, t, t_best)
        k_best = torch.where(win, key, k_best)

    if march is not None and ns:
        # the interior pseudo-hit: t = cmax while the step ends inside
        k = last.clamp(0, ns - 1)
        center, radius = V3.from_array(scn.sph_center[k]), scn.sph_radius[k]
        t = sphere_t(org, dir, cmin, cmax, center, radius)
        inside = (org + dir * cmax - center).length_squared() <= radius * radius
        t = torch.where(inside, cmax, t)
        m = skip_last & (last >= 0)
        prim_tests = prim_tests + m.to(torch.int64)
        win = m & ((t < t_best) | ((t == t_best) & (last < k_best)))
        t_best, k_best = torch.where(win, t, t_best), torch.where(win, last, k_best)

    for i in range(bvh.n_always):
        key = bvh.keys[i].expand(B)
        m = live0 & ~(skip_last & (key == last))
        prim_tests = prim_tests + m.to(torch.int64)
        consider(key, m)

    if bvh.n_node:
        inv, pad0, pad1, t_a = ray_setup(org, dir, bvh.head)
        tp = pad_for(inv, pad0, pad1, t_a, torch.fmin(cmax, t_best))
        node = torch.zeros(B, dtype=torch.int64, device=dev)
        sp = torch.zeros(B, dtype=torch.int64, device=dev)
        stack = torch.zeros((*B, BVH_STACK), dtype=torch.int64, device=dev)
        lanes = torch.arange(B[0], device=dev)
        slots = torch.arange(LEAF_MAX, device=dev)
        n_key = bvh.keys.numel()
        # each lane's state: at a node whose box it meets (to expand), or
        # popping; the root's box first
        node_tests = node_tests + live0.to(torch.int64)
        at, _ = node_visit(bvh.nodes[node], org, inv, tp, cmin, torch.fmin(cmax, t_best))
        at = at & live0
        popping = live0 & ~at
        while bool((at | popping).any()):
            nd = bvh.nodes[node]
            count = nd[:, 7]
            leaf = at & (count > 0.0)
            inner = at & (count <= 0.0)
            if bool(leaf.any()):  # a leaf's primitives, then pop
                keys = bvh.keys[(nd[:, 6].long()[:, None] + slots).clamp(0, n_key - 1)]
                m = leaf[:, None] & (slots < count[:, None]) & ~(skip_last[:, None]
                                                                  & (keys == last[:, None]))
                prim_tests = prim_tests + m.sum(dim=1)
                rep = lambda v: v.repeat_interleave(LEAF_MAX)  # noqa: E731
                t, _, _ = _prim_t(V3(*map(rep, org)), V3(*map(rep, dir)), rep(cmin), rep(cmax),
                                  scn, keys.reshape(-1).clamp(0, ns + nt + nb - 1))
                t = t.view(*B, LEAF_MAX)
                for j in range(LEAF_MAX):
                    win = m[:, j] & ((t[:, j] < t_best) | ((t[:, j] == t_best)
                                                           & (keys[:, j] < k_best)))
                    t_best = torch.where(win, t[:, j], t_best)
                    k_best = torch.where(win, keys[:, j], k_best)
                tp = V3.where(leaf, pad_for(inv, pad0, pad1, t_a, torch.fmin(cmax, t_best)), tp)
            # an inner node: both children's boxes, the nearer entry first,
            # the other pushed; neither met: pop
            tlim = torch.fmin(cmax, t_best)
            left, right = node + 1, nd[:, 6].long()
            v_l, tn_l = node_visit(bvh.nodes[left.clamp(max=bvh.n_node - 1)], org, inv, tp, cmin,
                                   tlim)
            v_r, tn_r = node_visit(bvh.nodes[right.clamp(0, bvh.n_node - 1)], org, inv, tp, cmin,
                                   tlim)
            node_tests = node_tests + 2 * inner.to(torch.int64)
            v_l, v_r = inner & v_l, inner & v_r
            both = v_l & v_r
            l_first = tn_l <= tn_r
            far = torch.where(l_first, right, left)
            top = sp.clamp(max=BVH_STACK - 1)
            stack[lanes, top] = torch.where(both, far, stack[lanes, top])
            sp = sp + both.to(torch.int64)
            go_l = torch.where(both, l_first, v_l)
            nxt = torch.where(go_l, left, right)
            # a popped node is tested again: t_best may have shrunk since its push
            pop = popping & (sp > 0)
            sp = sp - pop.to(torch.int64)
            popped = stack[lanes, sp.clamp(0, BVH_STACK - 1)]
            v_p, _ = node_visit(bvh.nodes[popped], org, inv, tp, cmin, tlim)
            node_tests = node_tests + pop.to(torch.int64)
            node = torch.where(v_l | v_r, nxt, torch.where(pop, popped, node))
            new_at = (v_l | v_r) | (pop & v_p)
            popping = (popping & ~(popping & (sp == 0) & ~pop) & ~(pop & v_p)) | leaf \
                | (inner & ~(v_l | v_r))
            at = new_at

    valid = torch.isfinite(t_best)
    key = torch.where(valid, k_best, -1)
    k = key.clamp(0, ns + nt + nb - 1)
    is_sph = valid & (key < ns)
    surf_rect = valid & ~is_sph
    _, c_p, c_zb = _prim_t(org, dir, cmin, cmax, scn, k)
    c_p = torch.where(surf_rect, c_p, 0.0)
    c_zb = V3.where(surf_rect, c_zb, V3.zeros(B, dev))
    cat = lambda *a: torch.cat(a)  # noqa: E731
    r = slice(0, nt)
    mtypes = cat(scn.sph_mtype, scn.rct_mtype[r], scn.box_mtype)
    colors = cat(_color_rows(scn.sph_mtype, scn.sph_albedo, scn.sph_emitted),
                 _color_rows(scn.rct_mtype[r], scn.rct_albedo[r], scn.rct_emitted[r]),
                 _color_rows(scn.box_mtype, scn.box_albedo, scn.box_emitted))
    roughs = cat(scn.sph_rough, scn.rct_rough[r], scn.box_rough)
    iors = cat(scn.sph_ior, scn.rct_ior[r], scn.box_ior)
    if not (ns + nt + nb):  # no primitive: every lane misses
        mtypes = torch.zeros(1, dtype=torch.int32, device=dev)
        colors = torch.zeros((1, 3), device=dev)
        roughs, iors = torch.zeros(1, device=dev), torch.ones(1, device=dev)
    c_mtype = torch.where(valid, mtypes[k], 0).to(torch.int32)
    c_color = V3.from_array(torch.where(valid[:, None], colors[k], 0.0))
    c_rough = torch.where(valid, roughs[k], 0.0)
    c_ior = torch.where(valid, iors[k], 1.0)
    zero = torch.zeros(B, device=dev)
    srow = torch.where(is_sph, key, -1)
    c_center, c_radius, c_vsize = V3(zero, zero, zero), zero + 1.0, V3(zero, zero, zero)
    c_vgrid = torch.full(B, -1, dtype=torch.int32, device=dev)
    interior = torch.zeros(B, dtype=torch.bool, device=dev)
    if ns:
        ks = k.clamp(max=ns - 1)
        c_center = V3(*(torch.where(is_sph, scn.sph_center[ks, i], 0.0) for i in range(3)))
        c_radius = torch.where(is_sph, scn.sph_radius[ks], 1.0)
        if carry_volumes:
            c_vsize = V3(*(torch.where(is_sph, scn.sph_vol_size[ks, i], 0.0) for i in range(3)))
            c_vgrid = torch.where(is_sph, scn.sph_vol_grid[ks], -1).to(torch.int32)
        if march is not None:
            end = org + dir * cmax
            inside = (end - c_center).length_squared() <= c_radius * c_radius
            interior = is_sph & march & (key == last) & inside
    hit = _manifold(org, dir, t_best, is_sph, srow, interior, c_center, c_radius, c_zb, c_p,
                    c_mtype, c_color, c_rough, c_ior, c_vgrid, c_vsize, ns > 0, nt + nb > 0)
    return BvhHit(hit, key, node_tests, prim_tests)


def uses_bvh(cfg) -> bool:
    """Whether the CUDA tracer walks the BVH for ``cfg``: the looped-sweep
    scenes (``render.LOOP_SWEEP_THRESHOLD``) without geodesics, whose
    chords keep the sweep."""
    return bool(cfg.looped_sweep and not cfg.geodesic)

