"""The BVH walk of the looped-sweep scenes (``bendy_tpu_torch/ops/bvh.py``)
against the sweep it replaces (CPU).

The CUDA tracer's BVH instantiations walk a tree of boxes instead of
testing every primitive row; the contract is the sweep's nearest hit, bit
for bit: the same winning primitive (the lexicographic least (t, key),
key = sphere row, then n_sph + rect row, then n_sph + n_rct + box row)
with the same t. ``nearest_hit_bvh_plain`` walks the same node block in
the kernel's f32 operations and order (chip_smoke.py phase 3 holds the
kernel's per-lane node and primitive test counts to it), so here it is
held to the port's sweep (``ops/intersect.nearest_hit``) on seeded and
adversarial rays, inside the tracer, and to the reference's looped sweep
(``bendy_tpu.ops.intersect.nearest_hit_looped``) run eagerly, where the
winners and their t agree bit for bit as well.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bendy_tpu.scene as ref_scene
from bendy_tpu.models.prim_grid import build_prim_grid as ref_build_prim_grid
from bendy_tpu.ops import intersect as ref_isect
from bendy_tpu.utils.v3 import V3 as JV3
import bendy_tpu_torch as bt
from bendy_tpu_torch import Config, Output, Renderer, load_scene
from bendy_tpu_torch.ops import bvh
from bendy_tpu_torch.ops.intersect import INF, box_t, nearest_hit, rect_t, sphere_t
from bendy_tpu_torch.ops.trace_kernel import make_tracer, scene_table, tracer_table
from bendy_tpu_torch.ops.wavefront import trace_core
from bendy_tpu_torch.utils.rng import render_key
from bendy_tpu_torch.utils.v3 import V3
from torch_threads import one_intra_op_thread  # noqa: F401

SCENES = {
    "prim_grid_24": lambda: bt.build_prim_grid(24),
    "prim_grid_200": lambda: bt.build_prim_grid(200),
    "cloud_field": lambda: load_scene("scenes/cloud_field.json.gz"),
    "scene": lambda: load_scene("scenes/scene.json.gz"),
}


def _arrays(name):
    return Renderer(SCENES[name](), device="cpu").arrays


def _blocks(arrays):
    """The table's sphere, rect and box blocks and the node block built on them."""
    table, c = scene_table(arrays.host_copy())
    o1 = c["n_sph"] * bvh.SPH_COLS
    o2 = o1 + c["n_rct"] * bvh.RCT_COLS
    blocks = (table[:o1], table[o1:o2], table[o2:o2 + c["n_box"] * bvh.BOX_COLS])
    return blocks, bvh.build_bvh(*blocks)


def _tree(block):
    """(nodes [N,8], keys [K], n_always) of a node block."""
    n_node = int(block[bvh.H_NODES])
    end = bvh.BVH_HEAD + bvh.BVH_NODE * n_node
    nodes = block[bvh.BVH_HEAD:end].reshape(-1, bvh.BVH_NODE)
    return nodes, block[end:].astype(np.int64), int(block[bvh.H_ALWAYS])


@pytest.mark.parametrize("name", list(SCENES))
def test_build_invariants(name):
    """Every primitive key sits in exactly one leaf or in the always list;
    each node's box holds its children's and a leaf's box its primitives'
    exact boxes; the depth fits the kernel's stack; the huge primitives
    (a ground rect, scene.json's r = 100 ground sphere) are always tested."""
    arrays = _arrays(name)
    blocks, block = _blocks(arrays)
    nodes, keys, n_always = _tree(block)
    n_prim = arrays.n_spheres + arrays.n_trace_rects + arrays.n_boxes
    lo, hi, _, ok, radius = bvh.prim_boxes(*blocks)
    seen = list(keys[:n_always])
    depth = 0

    def walk(i, level):
        nonlocal depth
        depth = max(depth, level)
        box_lo, box_hi = nodes[i, 0:3].astype(np.float64), nodes[i, 3:6].astype(np.float64)
        if nodes[i, 7] > 0:
            first, count = int(nodes[i, 6]), int(nodes[i, 7])
            assert 1 <= count <= bvh.LEAF_MAX
            members = keys[first:first + count]
            seen.extend(members)
            assert (lo[members] >= box_lo).all() and (hi[members] <= box_hi).all()
            return box_lo, box_hi
        assert nodes[i, 7] == -1.0
        for child in (i + 1, int(nodes[i, 6])):
            c_lo, c_hi = walk(child, level + 1)
            assert (c_lo >= box_lo).all() and (c_hi <= box_hi).all(), (i, child)
        return box_lo, box_hi

    if len(nodes):
        walk(0, 1)
    assert sorted(seen) == list(range(n_prim))
    assert depth <= bvh.BVH_STACK and len(nodes) < bvh.MAX_NODES
    assert ok.all()
    always = set(keys[:n_always].tolist())
    if name.startswith("prim_grid"):
        assert arrays.n_spheres in always  # the ground, the first rect
    if name == "scene":
        assert int(np.argmax(radius)) in always and radius.max() >= 100.0
    if name == "cloud_field":
        assert n_always == 0 and len(nodes) > 0


def test_build_scales_and_bounds_the_stack():
    """build_prim_grid(3072): every key once, node indices within uint16
    (the depth is held to the stack while building)."""
    arrays = Renderer(bt.build_prim_grid(3072), device="cpu").arrays
    _, block = _blocks(arrays)
    nodes, keys, _ = _tree(block)
    assert sorted(keys) == list(range(arrays.n_spheres + arrays.n_trace_rects + arrays.n_boxes))
    assert 0 < len(nodes) < bvh.MAX_NODES


def _depth(block):
    nodes, _, _ = _tree(block)

    def depth(i):
        return 1 if nodes[i, 7] > 0 else 1 + max(depth(i + 1), depth(int(nodes[i, 6])))

    return depth(0)


def test_build_falls_back_to_median_splits_past_the_stack(monkeypatch):
    """A tree deeper than the kernel's stack is built again with median
    splits (prim_grid(200): SAH depth 8, median depth 7); shallower than
    that the build raises instead of emitting a tree the kernel cannot
    walk."""
    blocks, block = _blocks(_arrays("prim_grid_200"))
    assert _depth(block) == 8
    monkeypatch.setattr(bvh, "BVH_STACK", 7)
    median = bvh.build_bvh(*blocks)
    assert _depth(median) == 7
    _, keys, _ = _tree(median)
    assert sorted(keys) == sorted(_tree(block)[1])
    monkeypatch.setattr(bvh, "BVH_STACK", 6)
    with pytest.raises(ValueError, match="depth"):
        bvh.build_bvh(*blocks)


def test_tracer_table_appends_the_node_block():
    """tracer_table keeps scene_table's every offset and appends the node
    block at a float4 boundary for a looped-sweep configuration in flat
    space; otherwise the table is scene_table's."""
    r = Renderer(bt.build_prim_grid(200), device="cpu")
    cam = r.scene.find_by_tag("camera")
    cfg = r.trace_config(r.config, cam)
    assert cfg.looped_sweep
    base, counts0 = scene_table(r.arrays.host_copy())
    table, counts = tracer_table(r.arrays.host_copy(), cfg)
    np.testing.assert_array_equal(table[:base.size], base)
    assert counts["bvh0"] % 4 == 0 and counts["bvh0"] >= base.size
    block = table[counts["bvh0"]:]
    assert counts["n_node"] == int(block[0]) > 0
    assert block.size == bvh.BVH_HEAD + bvh.BVH_NODE * counts["n_node"] + counts["n_key"]
    assert {k: counts[k] for k in counts0} == counts0
    for other in (replace(cfg, looped_sweep=False), replace(cfg, geodesic=True)):
        t2, c2 = tracer_table(r.arrays.host_copy(), other)
        np.testing.assert_array_equal(t2, base)
        assert c2 == counts0


def test_make_tracer_counts_tests_only_on_the_kernel_walk():
    """``count_tests`` asks the kernel's BVH walk for its per-lane counts:
    the plain route on the CPU sweeps every primitive and refuses it."""
    r = Renderer(bt.build_prim_grid(200), device="cpu")
    cam = r.scene.find_by_tag("camera")
    cfg = r.trace_config(r.config, cam)
    r.camera_params(cam)
    tracer = make_tracer(r.arrays, 4, 4, 1, 1, cfg)
    pix = torch.arange(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="count_tests"):
        tracer(r._cam_packed, 1, 0, pix, torch.zeros_like(pix), count_tests=True)
    assert int(tracer(r._cam_packed, 1, 0, pix, torch.zeros_like(pix)).rays) > 0


# --- the walk against the sweep ----------------------------------------------

def _tv(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i], np.float32)) for i in range(3)))


def _sweep_key(org, d, cmin, cmax, scn, march=None, last=None):
    """The sweep's winning key: the first row with the smallest t."""
    ts = []
    ns, nt = scn.n_spheres, scn.n_trace_rects
    for k in range(ns):
        c, r = V3.from_array(scn.sph_center[k].expand(org.x.shape[0], 3)), scn.sph_radius[k]
        t = sphere_t(org, d, cmin, cmax, c, r)
        if march is not None:
            inside = (org + d * cmax - c).length_squared() <= r * r
            t = torch.where(march & (last == k) & inside, torch.zeros_like(t) + cmax, t)
        ts.append(t)
    for k in range(nt):
        t, _ = rect_t(org, d, cmin, cmax, *(V3.from_array(a[k].expand(org.x.shape[0], 3))
                                            for a in (scn.rct_center, scn.rct_x, scn.rct_y,
                                                      scn.rct_z)), scn.rct_hw[k], scn.rct_hh[k])
        ts.append(t)
    for k in range(scn.n_boxes):
        t, _, _ = box_t(org, d, cmin, cmax, scn.box_n[k][..., None], scn.box_dlo[k][:, None],
                        scn.box_dhi[k][:, None], scn.box_sgn_lo[k][:, None],
                        scn.box_sgn_hi[k][:, None])
        ts.append(t)
    t_all = torch.stack(ts)
    t_all = torch.where(torch.isnan(t_all), INF, t_all)
    key = t_all.argmin(dim=0)
    return torch.where(torch.isfinite(t_all.min(dim=0).values), key, -1)


def _rays(name, scn, g, n):
    """Seeded rays: random ones through the scene, spheres grazed along
    tangents, rays along box edges and inside box faces, and march steps
    from inside volume spheres with their last sphere set."""
    host = scn.host_copy()
    lo, hi, _, ok, _ = bvh.prim_boxes(*_blocks(scn)[0])
    small = ok & (np.linalg.norm(hi - lo, axis=1) < 50.0)
    mid = (lo[small].min(0) + hi[small].max(0)) / 2
    half = (hi[small].max(0) - lo[small].min(0)) / 2 + 1.0
    org = mid + g.uniform(-1.2, 1.2, (n, 3)) * half
    d = g.normal(size=(n, 3))
    rays = [(org, d, "random")]
    if host.sph_radius.size:
        k = g.integers(0, host.sph_radius.size, n)
        c, r = host.sph_center[k].astype(np.float64), host.sph_radius[k].astype(np.float64)
        d = g.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        p = np.cross(d, g.normal(size=(n, 3)))
        p /= np.linalg.norm(p, axis=1, keepdims=True)
        dist = g.uniform(0.5, 30.0, n)[:, None]
        rays.append((c + p * r[:, None] * (1 + g.normal(0, 1e-6, (n, 1))) - d * dist, d,
                     "tangent"))
    if host.box_rough.size:
        nb = host.box_rough.size
        k = g.integers(0, nb, n)
        rows = host.box_n[k].astype(np.float64)
        inv = np.linalg.inv(rows)
        bits = g.integers(0, 2, (n, 2, 3)).astype(np.float64)
        dlo, dhi = host.box_dlo[k].astype(np.float64), host.box_dhi[k].astype(np.float64)
        ca = np.einsum("nij,nj->ni", inv, dlo + bits[:, 0] * (dhi - dlo))
        # an adjacent corner: flip one slab
        axis = g.integers(0, 3, n)
        flip = bits[:, 0].copy()
        flip[np.arange(n), axis] = 1 - flip[np.arange(n), axis]
        cb = np.einsum("nij,nj->ni", inv, dlo + flip * (dhi - dlo))
        e = cb - ca
        rays.append((ca - e * g.uniform(0.5, 5.0, (n, 1)), e, "box edge"))
        # inside a face plane: the lo plane of slab `axis`, toward a point on it
        f = np.einsum("nij,nj->ni", inv, dlo + g.uniform(0, 1, (n, 3)) * (dhi - dlo) * (
            np.arange(3)[None] != axis[:, None]))
        q = np.einsum("nij,nj->ni", inv, dlo + g.uniform(0, 1, (n, 3)) * (dhi - dlo) * (
            np.arange(3)[None] != axis[:, None]))
        rays.append((f - (q - f) * 3.0, q - f, "box face"))
    return rays


def _same(x, y) -> bool:
    """Equal values, NaN where the other is NaN (a zero's sign aside: the
    sweep adds 0 to its rect normals, which turns -0 into +0, and the
    kernel and the walk read them as stored)."""
    return bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())


def _hit_fields_equal(a, b):
    """The Hit fields the tracer reads: t bit for bit, the rest equal."""
    assert torch.equal(a.t.view(torch.int32), b.t.view(torch.int32)), "t"
    for f in ("face", "mtype", "rough", "ior", "vol_grid", "sphere_row"):
        assert _same(getattr(a, f), getattr(b, f)), f
    for f in ("position", "normal", "albedo", "emitted"):
        for c in "xyz":
            assert _same(getattr(getattr(a, f), c), getattr(getattr(b, f), c)), f"{f}.{c}"


@pytest.mark.parametrize("name", list(SCENES))
def test_walk_matches_the_sweep_bit_for_bit(name):
    """Seeded and adversarial rays (tangent to spheres, along box edges and
    in box faces), clip [0.01, 1000]: the walk's winner key equals the
    sweep's first row with the smallest t, and every Hit field is
    bit-equal, as are the march steps' (clip [0, 0.1], the last sphere set)
    on cloud_field."""
    scn = _arrays(name)
    _, block = _blocks(scn)
    tables = bvh.bvh_tables(block, "cpu")
    g = np.random.default_rng(23)
    n = 512
    for org, d, what in _rays(name, scn, g, n):
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        o, dv = _tv(org.astype(np.float32)), _tv(d.astype(np.float32))
        walk = bvh.nearest_hit_bvh_plain(o, dv, 0.01, 1000.0, scn, tables)
        _hit_fields_equal(walk.hit, nearest_hit(o, dv, 0.01, 1000.0, scn))
        assert torch.equal(walk.key, _sweep_key(o, dv, 0.01, 1000.0, scn)), what
        assert int((walk.key >= 0).sum()) > 0, what
        assert float(walk.prim_tests.float().mean()) < scn.n_spheres + scn.n_trace_rects \
            + scn.n_boxes or name == "scene", what
    if name == "cloud_field":
        host = scn.host_copy()
        k = g.integers(0, scn.n_spheres, n)
        u = g.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        org = host.sph_center[k] + u * host.sph_radius[k, None] * g.uniform(0.0, 1.05, (n, 1))
        d = g.normal(size=(n, 3))
        # off-unit directions, as the polynomial sin/cos leave scattered ones
        d = d / np.linalg.norm(d, axis=1, keepdims=True) * (1 + g.uniform(-3e-5, 3e-5, (n, 1)))
        o, dv = _tv(org.astype(np.float32)), _tv(d.astype(np.float32))
        march = torch.from_numpy(g.random(n) < 0.9)
        last = torch.from_numpy(np.where(g.random(n) < 0.8, k, g.integers(-1, scn.n_spheres, n)))
        last = last.to(torch.int32)
        walk = bvh.nearest_hit_bvh_plain(o, dv, 0.0, 0.1, scn, tables, march=march,
                                         last_sphere=last)
        _hit_fields_equal(walk.hit, nearest_hit(o, dv, 0.0, 0.1, scn, march=march,
                                                last_sphere=last))
        assert torch.equal(walk.key, _sweep_key(o, dv, 0.0, 0.1, scn, march, last.long()))
        assert int((walk.hit.face == 2).sum()) > n // 4  # interior pseudo-hits won
        assert float(walk.prim_tests.float().mean()) < 16.0


def _tie_scene():
    """Exact ties: two identical spheres, two coincident rects, a box whose
    top face is coincident with a rect, plus enough filler for a tree."""
    from bendy_tpu_torch import Cuboid, Data, Material, Object, Rect, Scene, Sphere

    scene = Scene()
    scene.set_root_material(scene.add_data(Data(Material.flat((0.1, 0.1, 0.1)))))
    mats = [scene.add_data(Data(Material.flat((0.2 * i, 0.5, 0.5)))) for i in range(4)]
    for i in range(2):
        scene.add_object(Object(Sphere(material=mats[i], radius=1.0)).with_translation([0, 1, 0]))
    for i in range(2):
        scene.add_object(Object(Rect.from_edges(mats[i + 2], [2, 0, 0], [0, 0, -2]))
                         .with_translation([4, 1, 0]))
    scene.add_object(Object(Cuboid.from_axes(mats[0], [1, 0, 0], [0, 0.5, 0], [0, 0, 1]))
                     .with_translation([4, 0.5, 0]))
    for i in range(12):
        scene.add_object(Object(Sphere(material=mats[i % 4], radius=0.3))
                         .with_translation([-6 + i, 0.3, 5]))
    return scene


def test_walk_takes_the_lower_key_on_exact_ties():
    """Rays down onto two identical spheres, two coincident rects and a box
    face lying in a rect: equal t, and the walk keeps the lower key as the
    sweep keeps the first row."""
    scn = Renderer(_tie_scene(), device="cpu").arrays
    _, block = _blocks(scn)
    tables = bvh.bvh_tables(block, "cpu")
    g = np.random.default_rng(5)
    n = 256
    x = np.where(np.arange(n) < n // 2, g.uniform(-0.5, 0.5, n), 4.0 + g.uniform(-0.9, 0.9, n))
    org = np.stack([x, np.full(n, 5.0), g.uniform(-0.5, 0.5, n)], 1)
    d = np.tile([0.0, -1.0, 0.0], (n, 1))
    o, dv = _tv(org.astype(np.float32)), _tv(d.astype(np.float32))
    walk = bvh.nearest_hit_bvh_plain(o, dv, 0.01, 1000.0, scn, tables)
    key = _sweep_key(o, dv, 0.01, 1000.0, scn)
    assert torch.equal(walk.key, key)
    _hit_fields_equal(walk.hit, nearest_hit(o, dv, 0.01, 1000.0, scn))
    ns = scn.n_spheres
    assert set(key[: n // 2].tolist()) == {0}  # sphere 1 ties sphere 0 everywhere
    assert not bool((key == ns + 1).any()) and bool((key[n // 2:] == ns).any())  # the rects


# --- inside the tracer --------------------------------------------------------

@pytest.mark.parametrize("name,W,mb,seed", [("prim_grid_24", 8, 4, 7), ("cloud_field", 6, 4, 11),
                                            ("light_field_200", 8, 3, 5)])
def test_trace_core_with_the_walk_is_bit_equal(name, W, mb, seed):
    """trace_core with the walk in place of the sweep (``bvh=``) renders the
    same image bit for bit with the same rays, and counts each lane's node
    and primitive tests (NORMAL output, spp 2)."""
    scene = bt.build_light_field(200) if name == "light_field_200" else SCENES[name]()
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = 1.0
    r = Renderer(scene, Config(max_bounces=mb, output=Output.NORMAL), device="cpu")
    cfg = replace(r.trace_config(r.config, cam), looped_sweep=True)
    table, counts = tracer_table(r.arrays.host_copy(), cfg)
    tables = bvh.bvh_tables(table[counts["bvh0"]:], "cpu")
    args = (r.arrays, r.camera_params(cam), render_key(seed, 0), torch.arange(W * W),
            torch.zeros(W * W, dtype=torch.int64), W, W, 2, 1, cfg)
    sweep = trace_core(*args)
    walk = trace_core(*args, bvh=tables)
    for f in ("radiance", "aov_albedo", "aov_normal"):
        for c in "xyz":
            assert torch.equal(getattr(getattr(walk, f), c), getattr(getattr(sweep, f), c)), f
    assert torch.equal(walk.aov_depth, sweep.aov_depth)
    assert int(walk.rays) == int(sweep.rays) > 0
    lc = walk.lane_counts
    n_prim = counts["n_sph"] + counts["n_rct"] + counts["n_box"]
    assert int(lc["prim_tests"].sum()) < n_prim * int(walk.rays)
    assert bool((lc["node_tests"][lc["rays"] > 0] > 0).all())
    assert "node_tests" not in sweep.lane_counts


# --- against the reference's looped sweep --------------------------------------

@pytest.mark.parametrize("name", ["prim_grid_24", "cloud_field"])
def test_walk_matches_the_reference_looped_sweep(name):
    """The same rays through ``bendy_tpu``'s looped sweep, run eagerly
    (``jax.disable_jit()``, as tests/test_torch_looped.py runs the
    reference): the same winners (valid, face, material, sphere row) and t
    bit for bit, on surface segments and (cloud_field) march steps."""
    path = "scenes/cloud_field.json.gz"
    ref_s = ref_build_prim_grid(24) if name == "prim_grid_24" else ref_scene.load_scene(path)
    ref_arrays = ref_scene.compile_scene(ref_s)
    scn = _arrays(name)
    _, block = _blocks(scn)
    tables = bvh.bvh_tables(block, "cpu")
    g = np.random.default_rng(31)
    n = 128
    org, d, _ = _rays(name, scn, g, n)[1]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    org = org.astype(np.float32)
    march = g.random(n) < (0.5 if name == "cloud_field" else 0.0)
    last = g.integers(0, scn.n_spheres, n).astype(np.int32)
    cmin = np.where(march, 0.0, 0.01).astype(np.float32)
    cmax = np.where(march, 0.1, 1000.0).astype(np.float32)
    jv = lambda a: JV3(*(jnp.asarray(a[:, i]) for i in range(3)))  # noqa: E731
    kw = {}
    if name == "cloud_field":
        kw = dict(march=jnp.asarray(march), last_sphere=jnp.asarray(last))
    with jax.disable_jit():
        ref = ref_isect.nearest_hit_looped(jv(org), jv(d), jnp.asarray(cmin), jnp.asarray(cmax),
                                           ref_arrays, **kw)
    tkw = {}
    if name == "cloud_field":
        tkw = dict(march=torch.from_numpy(march), last_sphere=torch.from_numpy(last))
    walk = bvh.nearest_hit_bvh_plain(_tv(org), _tv(d), torch.from_numpy(cmin),
                                     torch.from_numpy(cmax), scn, tables, **tkw)
    np.testing.assert_array_equal(walk.hit.t.numpy().view(np.int32),
                                  np.asarray(ref.t).view(np.int32))
    for f in ("valid", "face", "mtype", "sphere_row"):
        np.testing.assert_array_equal(getattr(walk.hit, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert int(walk.hit.valid.sum()) > n // 4
