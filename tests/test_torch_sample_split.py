"""The tracer split over samples (kernels 1b, 1d, 1e-iii), on the CPU.

The LOOPM instantiations of ``csrc/trace_surface.cu`` (looped masses) and
the item instantiations (unrolled masses, and media without the BVH)
trace each (lane, sample) on a thread of its own, and
``ops/trace_kernel.fold_samples`` adds a lane's samples in sample order
from 0, as one thread per lane adds its finished paths, so the split is
bit-equal to the lane loop. Here:

- (a) the split's plain form, ``trace_core`` at spp 1 for each sample,
  folded by ``fold_samples``, equals ``trace_core`` at the full spp bit
  for bit, per lane: radiance, AOVs, depth, rays, iterations, volume
  events and RK4 steps (mass_cluster at 8x8, spp 4, FULL and NORMAL; the
  13-mass ring; the 12-mass ring inside a medium; blackhole in FULL and
  NORMAL, binary_blackhole, cloud, dense_cloud and blackhole_cloud, the
  paths of the item instantiations; and cornell, cornell2 and scene in
  FULL and NORMAL, the surface paths, which the kernel traces one thread
  per lane: a split of their samples folds to the same sums);
- (b) the same split route on the 13-mass ring against ``bendy_tpu``'s XLA
  ``trace``: 0 lanes off and equal rays, as tests/test_torch_looped_masses.py
  holds the lane loop;
- (c) the plain fold against a Python loop of each lane's adds, in one
  chunk and carried across two;
- (d) no path of (a)'s cases takes more than ``cfg.max_iters(1)``
  iterations, so no sample is cut where the lane loop would not cut it;
- (e) the table-size rule: above 227 KiB the table stays in global memory,
  and ``_launch`` no longer refuses it;
- (f) the routing rule: which configurations trace per item and which
  keep one thread per lane;
- (g) the item limit: a chunk holds at most 2³¹ - 1 items.

chip_smoke.py holds the kernels themselves to ``trace_core`` on a card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bendy_tpu.scene as ref_scene
from bendy_tpu.geodesic import GeoParams as RefGeoParams
from bendy_tpu.ops.wavefront import trace as ref_trace
from bendy_tpu.render import Config as RefConfig
from bendy_tpu.render import Output as RefOutput
from bendy_tpu.render import Renderer as RefRenderer
from bendy_tpu.utils.rng import render_key as ref_key
import bendy_tpu_torch as bt
from bendy_tpu_torch import Config, GeoParams, Output, Renderer, dumps_scene
from bendy_tpu_torch.ops import trace_kernel
from bendy_tpu_torch.ops.trace_kernel import N_COUNTS, fold_samples, over_cap_lanes, per_item
from bendy_tpu_torch.ops.wavefront import TraceConfig, trace_core
from bendy_tpu_torch.utils.rng import render_key
from torch_threads import one_intra_op_thread  # noqa: F401

COUNTS = ("rays", "iters", "vol_events", "near_steps")


def ring(n_masses: int, medium: bool = False):
    """The reference's multi_mass_scene (tests/test_looped_masses.py:45-72),
    built with the port's scene graph; with ``medium`` inside a 2.5-radius
    volume sphere (:248-252)."""
    scene = bt.Scene()
    env = scene.add_data(bt.Data(bt.Material.emissive((0.2, 0.22, 0.3), 0.05)))
    scene.set_root_material(env)
    scene.add_object(bt.Object(bt.Camera(focal_length=0.05, sensor_size=0.024, focus=None))
                     .with_tag("camera").with_translation([0.0, 0.0, 18.0]))
    for k in range(n_masses):
        ang = 2.0 * np.pi * k / n_masses
        scene.add_object(bt.Object().with_tag(f"mass:{0.05 * (1 + k % 3)}").with_translation(
            [1.8 * np.cos(ang), 1.4 * np.sin(ang), 0.3 * (k % 2)]))
    for i, (px, py) in enumerate([(-4.0, 2.5), (3.5, -2.0), (0.2, 0.1), (5.0, 4.0)]):
        mat = scene.add_data(bt.Data(bt.Material.emissive((1.0, 0.8, 0.6), 1.5 + 0.3 * i)))
        scene.add_object(bt.Object(bt.Sphere(material=mat, radius=0.8))
                         .with_translation([px, py, -25.0]).with_flags(bt.ObjectFlags.LIGHT))
    if medium:
        vol = scene.add_data(bt.Data(bt.DensityMap.with_func(
            8, 8, 8, lambda x, y, z: 1.5 if (x + y + z) % 3 == 0 else 0.0)))
        shell = scene.add_data(bt.Data(bt.Material.flat((1.0, 1.0, 1.0))))
        scene.add_object(bt.Object(bt.Sphere(material=shell, radius=2.5, volume=vol)))
    return scene


def _scene(name: str):
    if name.startswith("ring_"):
        return ring(int(name.split("_")[1]), medium=name.endswith("medium"))
    return bt.load_scene(f"scenes/{name}.json.gz")


SURFACES = ("cornell", "cornell2", "scene")  # one thread per lane in the kernel


def setup(name: str, W: int, H: int, output: Output, **kw):
    """(Renderer on the CPU, camera id, TraceConfig) of a scene the kernel
    traces per item, or of a surface scene (one thread per lane)."""
    scene = _scene(name)
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = W / H
    r = Renderer(scene, Config(output=output, **kw), device="cpu")
    cfg = r.trace_config(r.config, cam)
    assert per_item(cfg) == (name not in SURFACES)
    return r, cam, cfg


def words(res, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """A TraceSums as the kernel's per-item words: [n_out, B] f32 sums (the
    AOVs with depth_n applied) and [N_COUNTS, B] int32 counts."""
    f = [*res.radiance]
    if cfg.want_aovs:
        f += [*res.aov_albedo, *res.aov_normal, res.aov_depth]
    return (torch.stack(f).contiguous(),
            torch.stack([res.lane_counts[k] for k in COUNTS]).to(torch.int32))


def split_route(r, cam, cfg, W, H, spp, seed, chunk=None):
    """The split's plain form: each sample traced alone (``trace_core`` at
    spp 1 with the global ``spp_total`` and its own ``sample0``), laid out
    per item (item = lane·spp + s) and folded chunk by chunk. Returns the
    per-lane (out, counts) and each sample's (out, counts)."""
    B = W * H
    pix, sub = torch.arange(B), torch.zeros(B, dtype=torch.int64)
    per = [words(trace_core(r.arrays, r.camera_params(cam), render_key(seed, 0), pix, sub, W,
                            H, 1, 1, cfg, spp_total=spp, sample0=s), cfg)
           for s in range(spp)]
    n_out = per[0][0].shape[0]
    out = torch.empty(n_out, B)
    cnt_out = torch.empty(N_COUNTS, B, dtype=torch.int32)
    chunk = chunk or spp
    for c0 in range(0, spp, chunk):
        s = min(chunk, spp - c0)
        samp = torch.stack([p[0] for p in per[c0:c0 + s]], dim=2).reshape(n_out, B * s)
        cnt = torch.stack([p[1] for p in per[c0:c0 + s]], dim=2).reshape(N_COUNTS, B * s)
        fold_samples(samp, cnt, s, out, *cnt_out, first=c0 == 0,
                     max_iters=cfg.max_iters(spp) if c0 + s == spp else -1,
                     over_cap=over_cap_lanes("cpu"))
    return (out, cnt_out), per


# (scene, W, H, spp, Config kwargs, seed, output)
CASES = [
    ("mass_cluster", 8, 8, 4, dict(max_bounces=2), 3, Output.FULL),
    ("mass_cluster", 8, 8, 4, dict(max_bounces=2), 3, Output.NORMAL),
    ("ring_13", 8, 8, 3, dict(max_bounces=2, geo=GeoParams(max_steps=96)), 3, Output.NORMAL),
    ("ring_12_medium", 8, 8, 2, dict(max_bounces=2, max_volume_bounces=8,
                                     geo=GeoParams(max_steps=64)), 21, Output.NORMAL),
    # the item instantiations: unrolled masses, media, both
    ("blackhole", 8, 8, 4, dict(max_bounces=2), 3, Output.FULL),
    ("blackhole", 8, 8, 4, dict(max_bounces=2), 3, Output.NORMAL),
    ("binary_blackhole", 8, 8, 3, dict(max_bounces=2), 3, Output.NORMAL),
    ("cloud", 8, 8, 4, dict(max_bounces=3), 11, Output.NORMAL),
    ("dense_cloud", 8, 8, 2, dict(max_bounces=3), 11, Output.NORMAL),
    ("blackhole_cloud", 8, 8, 4, dict(max_bounces=2, volume_step=0.6), 3, Output.NORMAL),
    # the surface paths (kernel 1a)
    ("cornell", 8, 8, 4, dict(max_bounces=3), 7, Output.FULL),
    ("cornell", 8, 8, 4, dict(max_bounces=3), 7, Output.NORMAL),
    ("cornell2", 8, 8, 4, dict(max_bounces=3), 7, Output.FULL),
    ("cornell2", 8, 8, 4, dict(max_bounces=3), 7, Output.NORMAL),
    ("scene", 8, 8, 4, dict(max_bounces=3), 7, Output.FULL),
    ("scene", 8, 8, 4, dict(max_bounces=3), 7, Output.NORMAL),
]
IDS = [f"{c[0]}-{c[6].value}" for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_equals_lane_loop_bit_for_bit(case):
    """(a) and (d): the folded per-sample traces equal the lane loop per
    lane, bit for bit, and no path outgrows one sample's cap."""
    name, W, H, spp, kw, seed, output = case
    r, cam, cfg = setup(name, W, H, output, **kw)
    B = W * H
    over_cap_lanes("cpu").zero_()
    (out, cnt), per = split_route(r, cam, cfg, W, H, spp, seed)
    whole = trace_core(r.arrays, r.camera_params(cam), render_key(seed, 0), torch.arange(B),
                       torch.zeros(B, dtype=torch.int64), W, H, spp, 1, cfg)
    want_f, want_c = words(whole, cfg)
    assert torch.equal(out.view(torch.int32), want_f.view(torch.int32))  # bit for bit
    assert torch.equal(cnt, want_c), (cnt.sum(dim=1), want_c.sum(dim=1))
    assert int(over_cap_lanes("cpu")) == 0
    longest = max(int(p[1][1].max()) for p in per)
    assert longest <= cfg.max_iters(1), (longest, cfg.max_iters(1))
    assert float(out[0].sum()) > 0.0 and int(cnt[0].sum()) > 0
    if cfg.geodesic and name != "ring_12_medium":
        assert int(cnt[3].sum()) > 0  # the RK4 steps were taken and counted
    if cfg.has_volumes and name != "ring_12_medium":
        assert int(cnt[2].sum()) > 0  # the volume events too


def test_split_matches_xla_on_the_ring():
    """(b): the split route on the 13-mass ring (16x16, spp 2, NORMAL,
    max_steps 96) against the XLA trace: 0 lanes off in radiance, albedo
    and normal at rtol 5e-4 / atol 1e-5, equal rays."""
    W = H = 16
    spp, seed = 2, 3
    r, cam, cfg = setup("ring_13", W, H, Output.NORMAL, max_bounces=2,
                        geo=GeoParams(max_steps=96))
    (out, cnt), _ = split_route(r, cam, cfg, W, H, spp, seed)
    ref_s = ref_scene.loads_scene(dumps_scene(ring(13)))
    ref_s.get_object(cam).inner.aspect_ratio = W / H
    ref_r = RefRenderer(ref_s, RefConfig(output=RefOutput.NORMAL, max_bounces=2,
                                         geo=RefGeoParams(max_steps=96)), use_pallas=False)
    rcfg = ref_r.trace_config(ref_r.config, cam)
    assert rcfg.looped_masses and rcfg.max_iters(spp) == cfg.max_iters(spp)
    ref = ref_trace(ref_r.arrays, ref_r.camera_params(cam), ref_key(jnp.uint32(seed), jnp.uint32(0)),
                    jnp.arange(W * H, dtype=jnp.uint32), jnp.zeros(W * H, jnp.uint32), W, H, spp,
                    1, rcfg)
    want = np.stack([np.asarray(c) for f in (ref.radiance, ref.aov_albedo, ref.aov_normal)
                     for c in f])
    got = out[:9].numpy()
    off = ~(np.abs(got - want) <= 1e-5 + 5e-4 * np.abs(want))
    assert int(off.any(axis=0).sum()) == 0
    assert int(cnt[0].sum()) == int(ref.rays)
    assert float(want[0].sum()) > 0.0


@pytest.mark.parametrize("chunks", [1, 2], ids=["one-chunk", "two-chunks"])
def test_fold_matches_a_python_loop(chunks):
    """(c): fold_samples on CPU tensors (its plain version) against each
    lane's adds written out, acc = acc + v from 0.0 in sample order; the
    counts as integers; the over-cap count; carried across two chunks."""
    g = np.random.default_rng(5)
    B, spp, n_out = 37, 6, 10
    # magnitudes far apart, so that another order of the adds would round
    # otherwise
    vals = (g.standard_normal((n_out, B, spp)) * 10.0 ** g.integers(-6, 6, (n_out, B, spp))
            ).astype(np.float32)
    cnts = g.integers(0, 300, (N_COUNTS, B, spp)).astype(np.int32)
    cap = 900
    out = torch.empty(n_out, B)
    c_out = torch.empty(N_COUNTS, B, dtype=torch.int32)
    over = torch.zeros(1, dtype=torch.int32)
    step = spp // chunks
    for c0 in range(0, spp, step):
        s = min(step, spp - c0)
        samp = torch.from_numpy(np.ascontiguousarray(vals[:, :, c0:c0 + s]).reshape(n_out, B * s))
        cnt = torch.from_numpy(np.ascontiguousarray(cnts[:, :, c0:c0 + s]).reshape(N_COUNTS, -1))
        fold_samples(samp, cnt, s, out, *c_out, first=c0 == 0,
                     max_iters=cap if c0 + s == spp else -1, over_cap=over)
    want = np.zeros((n_out, B), np.float32)
    for k in range(n_out):
        for lane in range(B):
            acc = np.float32(0.0)
            for s in range(spp):
                acc = np.float32(acc + vals[k, lane, s])
            want[k, lane] = acc
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(c_out.numpy(), cnts.sum(axis=2))
    assert int(over) == int((cnts[1].sum(axis=1) > cap).sum()) > 0
    with pytest.raises(ValueError, match="over_cap"):
        fold_samples(samp, cnt, s, out, *c_out, max_iters=cap)


def test_table_size_rule():
    """(e): the table stays in global memory above 227 KiB (the largest
    table a block can stage); _launch takes such a table up to its device
    check; build_prim_grid(3072) packs past the limit, 1024 does not."""
    assert not trace_kernel.table_in_global(227 * 1024)
    assert trace_kernel.table_in_global(227 * 1024 + 4)
    sizes = {}
    for n in (1024, 3072):
        scn = bt.compile_scene(bt.build_prim_grid(n), device="cpu")
        sizes[n] = trace_kernel.scene_table(scn.host_copy())[0].nbytes
    assert sizes == {1024: 88_372, 3072: 264_500}
    assert not trace_kernel.table_in_global(sizes[1024])
    assert trace_kernel.table_in_global(sizes[3072])
    table = torch.zeros(sizes[3072] // 4)
    pix = torch.zeros(4, dtype=torch.int32)
    counts = dict(n_sph=0, n_rct=0, n_box=0, n_light=0, n_face=0, n_mass=0)
    with pytest.raises(ValueError, match="launches on CUDA tensors"):
        trace_kernel._launch("bendy_trace_surface", trace_kernel.trace_surface, table, counts,
                             torch.zeros(32), pix, pix, 2, 2, 1, 1, 1, (0, 0), 0,
                             trace_kernel.TraceConfig())


def test_split_chunks_and_item_budget():
    """The wrapper's chunking: as many samples as the budget holds, at
    least one; the split route folded in chunks of one sample equals the
    one-chunk fold bit for bit (mass_cluster 4x4, spp 3)."""
    n_item = 4 * (trace_kernel.N_OUT + N_COUNTS)
    assert trace_kernel.split_samples(65_536, 16, trace_kernel.N_OUT) == 16
    assert trace_kernel.split_samples(1920 * 1080, 256, trace_kernel.N_OUT) == \
        trace_kernel.SPLIT_BUDGET_BYTES // (1920 * 1080 * n_item)
    assert trace_kernel.split_samples(10**9, 4, 3) == 1
    r, cam, cfg = setup("mass_cluster", 4, 4, Output.NORMAL, max_bounces=2)
    whole, _ = split_route(r, cam, cfg, 4, 4, 3, 9)
    chunked, _ = split_route(r, cam, cfg, 4, 4, 3, 9, chunk=1)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])


def test_routing_rule():
    """(f): looped masses (the LOOPM instantiations) and, without the BVH,
    geodesics and media (the item instantiations) trace per (lane, sample)
    item and fold; the surface and BVH instantiations keep one thread per
    lane. The rule over every (GEO, VOL, LOOPM, BVH) the kernel has."""
    route = {}
    for geo in (False, True):
        for vol in (False, True):
            for loopm in (False, True):
                for bvh in (False, True):
                    if (loopm and not geo) or (bvh and geo):
                        continue  # no such instantiation
                    cfg = TraceConfig(geodesic=geo, has_volumes=vol, looped_masses=loopm)
                    route[geo, vol, loopm, bvh] = per_item(cfg, bvh)
    assert route == {
        (False, False, False, False): False,  # surface (1a)
        (False, False, False, True): False,   # surface, BVH (1e-i)
        (False, True, False, False): True,    # media (1b, 1c)
        (False, True, False, True): False,    # media, BVH (1e-i)
        (True, False, False, False): True,    # unrolled masses (1d)
        (True, False, True, False): True,     # looped masses (1e-iii)
        (True, True, False, False): True,     # unrolled masses in media (1b + 1d)
        (True, True, True, False): True,      # looped masses in media
    }
    # looped masses select LOOPM by their flag; the kernel derives the rest
    # from its template flags by the same rule (PER_ITEM in the source)
    assert trace_kernel._flags(TraceConfig(geodesic=True, looped_masses=True)) & \
        trace_kernel.FLAG_LOOPM
    src = (Path(trace_kernel.__file__).parents[1] / "csrc" / "trace_surface.cu").read_text()
    rule = re.search(r"constexpr bool PER_ITEM = (.+);", src).group(1)
    rule = rule.replace("||", " or ").replace("&&", " and ").replace("!", " not ")
    for (geo, vol, _, bvh), want in route.items():
        assert eval(rule, {"GEO": geo, "VOL": vol, "BVH": bvh}) == want, (geo, vol, bvh)


def test_item_limit(monkeypatch):
    """(g): a chunk holds at most MAX_ITEMS = 2³¹ - 1 items (the kernel's
    int32 item ids), whatever the byte budget allows; more lanes than that
    raise, as no chunk of one sample fits."""
    assert trace_kernel.MAX_ITEMS == 2**31 - 1
    monkeypatch.setattr(trace_kernel, "SPLIT_BUDGET_BYTES", 1 << 62)
    lanes = 1920 * 1080
    s = trace_kernel.split_samples(lanes, 4096, 3)
    assert s == (2**31 - 1) // lanes == 1035 and lanes * s < 2**31
    assert trace_kernel.split_samples(2**30, 4, 3) == 1
    assert trace_kernel.split_samples(2**31 - 1, 4, 3) == 1
    with pytest.raises(ValueError, match="int32 items"):
        trace_kernel.split_samples(2**31, 1, 3)
