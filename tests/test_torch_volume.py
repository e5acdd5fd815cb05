"""Port parity for kernels 1b and 1c's modules: participating media (CPU).

``bendy_tpu_torch.ops.volume``, the march pseudo-hit of
``bendy_tpu_torch.ops.intersect.nearest_hit`` and the march mode of
``bendy_tpu_torch.ops.wavefront.trace_core`` are the plain version of the
CUDA tracer's volume instantiation (csrc/trace_surface.cu); chip_smoke.py
holds the kernel to them on a card. Here they are held to ``bendy_tpu``:

- ``density_sample`` against the reference's f32 einsum branch on 4,096
  seeded coordinates (0, 1, exact grid nodes and points outside the clamp
  among them) on the grids of volume, cloud and dense_cloud and on a
  two-grid stack: trilinear within atol 1e-6 (the nested lerp rounds once
  per product and sum, XLA's dot may fuse: at most ~2 ulp apart), nearest
  exactly;
- ``volume_shade`` on seeded hits;
- ``nearest_hit`` with march lanes on the four volume scenes: face codes,
  sphere rows and grids equal, positions within rtol 5e-4 / atol 1e-5;
- the integrator per lane against the XLA ``trace`` (16x16, spp 2, AOVs
  on): volume, cloud and dense_cloud at max_bounces 3, seed 11;
  blackhole_cloud at max_bounces 2, volume_step 0.6, seed 3. Budget: the
  reference's own between its two kernels (tests/test_pallas.py
  ``_volume_parity``: at most 1/128 of the lanes off per channel at rtol
  5e-4 / atol 1e-5, image means within 5e-3), and ray counts within 0.1 %.
  Measured: 0 lanes off in radiance in all four cases; 1 lane off in the
  NORMAL AOV on volume and on cloud; equal rays except blackhole_cloud
  (3 of 18,494). The cause is not the density: XLA rewrites 1/sqrt as
  rsqrt under jit, the port normalizes with 1/sqrt as the CUDA kernel
  does, and a small far sphere (|oc|² − r² cancels) or a scattered ray
  starting on a sphere turns that ulp into a different hit. With the
  reference's normalization replaced by 1/sqrt and run eagerly, the lanes
  agree step for step;
- the volume golden through ``Renderer(device="cpu")``: 8 of 256 pixels
  (18 of 768 values) leave it at its rtol 1e-5 / atol 1e-6, by the same
  cause at 8 spp; held at 16 pixels, with the image mean within 5e-3;
- row chunking, the CPU dispatch and the copied model builders.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bendy_tpu.models.dense_cloud as ref_dense
import bendy_tpu.scene as ref_scene
from bendy_tpu.models.blackhole_cloud import build_blackhole_cloud as ref_build_bhc
from bendy_tpu.ops import intersect as ref_isect
from bendy_tpu.ops import volume as ref_volume
from bendy_tpu.ops.wavefront import trace as ref_trace
from bendy_tpu.render import Config as RefConfig
from bendy_tpu.render import Output as RefOutput
from bendy_tpu.render import Renderer as RefRenderer
from bendy_tpu.utils.rng import render_key as ref_key
from bendy_tpu.utils.v3 import V3 as JV3
import bendy_tpu_torch
from bendy_tpu_torch import (
    Config,
    Film,
    Output,
    RenderConfig,
    Renderer,
    Subsample,
    dumps_scene,
    load_scene,
)
from bendy_tpu_torch.models.dense_cloud import blob_density
from bendy_tpu_torch.ops import intersect, volume
from bendy_tpu_torch.ops.trace_kernel import (
    make_tracer,
    scene_table,
    trace_geodesic,
    trace_surface,
    trace_volume,
)
from bendy_tpu_torch.ops.wavefront import trace_core
from bendy_tpu_torch.scene.compiler import compile_scene, scene_arrays_from_numpy
from bendy_tpu_torch.scene.graph import (
    Camera,
    Data,
    DensityMap,
    Material,
    Object,
    ObjectFlags,
    Scene,
    Sphere,
)
from bendy_tpu_torch.utils.rng import render_key
from bendy_tpu_torch.utils.v3 import V3
from torch_threads import one_intra_op_thread  # noqa: F401

W = H = 16
RTOL, ATOL = 5e-4, 1e-5
B = 4096
VOLUME_SCENES = ["volume", "cloud", "dense_cloud", "blackhole_cloud"]


def jv3(a):
    return JV3(*(jnp.asarray(a[:, i]) for i in range(3)))


def tv3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def two_grid_scene() -> Scene:
    """Two density grids of different extents, neither a multiple of the
    other, in one padded stack (tests/test_pallas.py's multi-grid scene)."""
    scene = Scene()
    env = scene.add_data(Data(Material.emissive((0.5, 0.6, 0.8), 0.1)))
    scene.set_root_material(env)
    scene.add_object(Object(Camera(focal_length=0.06, sensor_size=0.024, focus=None))
                     .with_tag("camera").with_translation([0.0, 0.0, 6.0]))

    def ramp(x, y, z):  # smooth gradient: exercises all 8 lerp corners
        return 0.2 + 0.05 * x + 0.08 * y + 0.11 * z

    vol_a = scene.add_data(Data(DensityMap.with_func(12, 10, 6, ramp)))
    vol_b = scene.add_data(Data(blob_density(8)))
    shell = scene.add_data(Data(Material.flat((1.0, 1.0, 1.0))))
    for vol, x in ((vol_a, -1.4), (vol_b, 1.4)):
        scene.add_object(Object(Sphere(material=shell, radius=1.2, volume=vol))
                         .with_translation([x, 0.0, 0.0]))
    light = scene.add_data(Data(Material.emissive((1.0, 0.9, 0.75), 8.0)))
    scene.add_object(Object(Sphere(material=light, radius=0.8)).with_translation([3.0, 2.5, 1.5])
                     .with_flags(ObjectFlags.LIGHT))
    return scene


def grid_tables(name: str):
    """(grid stack [G,D,H,W] f32, per-grid sizes [G,3]) of a scene."""
    scene = two_grid_scene() if name == "two_grids" else load_scene(f"scenes/{name}.json.gz")
    host = compile_scene(scene, device="cpu").host_copy()
    sizes = np.zeros((host.vol_grid.shape[0], 3), np.float32)
    for g, s in zip(host.sph_vol_grid, host.sph_vol_size):
        if g >= 0:
            sizes[g] = s
    return host.vol_grid, sizes


# --- the density lookup and the scatter decision ---------------------------

@pytest.mark.parametrize("nearest", [False, True], ids=["trilinear", "nearest"])
@pytest.mark.parametrize("name", ["volume", "cloud", "dense_cloud", "two_grids"])
def test_density_sample_matches_einsum(name, nearest):
    grid, sizes = grid_tables(name)
    g = np.random.default_rng(5)
    gidx = g.integers(0, grid.shape[0], B).astype(np.int32)
    size = sizes[gidx]
    coord = g.uniform(-0.1, 1.1, (B, 3)).astype(np.float32)  # past both clamp edges
    coord[:8] = [[0, 0, 0], [1, 1, 1], [0, 1, 0], [1, 0, 1], [0.5, 0.5, 0.5],
                 [0, 0.5, 1], [1, 0.5, 0], [0.25, 0.75, 0.125]]
    nodes = g.integers(0, 64, (256, 3)) / np.maximum(size[8:264], 1.0)  # exact grid nodes
    coord[8:264] = np.clip(nodes, 0.0, 1.0).astype(np.float32)
    ref = ref_volume.density_sample(
        SimpleNamespace(vol_grid=jnp.asarray(grid)),
        SimpleNamespace(vol_size=jv3(size), vol_grid=jnp.asarray(gidx)), jv3(coord),
        nearest=nearest)
    port = volume.density_sample(
        SimpleNamespace(vol_grid=torch.from_numpy(grid)),
        SimpleNamespace(vol_size=tv3(size), vol_grid=torch.from_numpy(gidx)), tv3(coord),
        nearest=nearest)
    ref = np.asarray(ref)
    assert ref.max() > 0.0
    if nearest:
        np.testing.assert_array_equal(port.numpy(), ref)
    else:
        np.testing.assert_allclose(port.numpy(), ref, rtol=0.0, atol=1e-6)
        assert (port.numpy() == ref).mean() > 0.5  # the same form, mostly bit-equal


@pytest.mark.parametrize("step", [0.1, 0.6])
def test_volume_shade_matches(step):
    grid, sizes = grid_tables("dense_cloud")
    g = np.random.default_rng(9)
    center = g.uniform(-2, 2, (B, 3)).astype(np.float32)
    radius = g.uniform(0.5, 6.0, B).astype(np.float32)
    pos = (center + g.uniform(-1, 1, (B, 3)) * radius[:, None]).astype(np.float32)
    d = g.normal(size=(B, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    face = g.integers(2, 5, B).astype(np.int32)
    size = np.repeat(sizes[:1], B, axis=0)
    bmin = (center - radius[:, None]).astype(np.float32)
    bsize = np.repeat((2.0 * radius)[:, None], 3, axis=1).astype(np.float32)
    zeros = np.zeros(B, np.int32)
    # u0 spread over [0, 2·step·density): the lanes scatter about half the time
    density = volume.density_sample(
        SimpleNamespace(vol_grid=torch.from_numpy(grid)),
        SimpleNamespace(vol_size=tv3(size), vol_grid=torch.from_numpy(zeros)),
        tv3((pos - bmin) / bsize)).numpy()
    u = g.uniform(0, 1, (4, B)).astype(np.float32)
    u[0] *= (2.0 * step * density).astype(np.float32)

    def hit(v3, arr):
        return SimpleNamespace(position=v3(pos), bbox_min=v3(bmin), bbox_size=v3(bsize),
                               vol_size=v3(size), vol_grid=arr(zeros), face=arr(face))

    ref = ref_volume.volume_shade(jv3(d), hit(jv3, jnp.asarray),
                                  SimpleNamespace(vol_grid=jnp.asarray(grid)),
                                  [jnp.asarray(x) for x in u], step)
    port = volume.volume_shade(tv3(d), hit(tv3, torch.from_numpy),
                               SimpleNamespace(vol_grid=torch.from_numpy(grid)),
                               [torch.from_numpy(x) for x in u], step)
    np.testing.assert_array_equal(port.scattered.numpy(), np.asarray(ref.scattered))
    assert 0.2 < port.scattered.float().mean() < 0.8
    np.testing.assert_array_equal(port.weight.numpy(), np.asarray(ref.weight))
    for a, b in zip((*port.origin, *port.direction), (*ref.origin, *ref.direction)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


# --- the march pseudo-hit -----------------------------------------------------

@pytest.mark.parametrize("name", VOLUME_SCENES)
def test_nearest_hit_march_matches(name):
    """March lanes start inside or near the volume sphere with the march
    clip; the others trace with the surface clip. Faces, sphere rows and
    grids equal; t and positions within rtol 5e-4 / atol 1e-5."""
    ref = ref_scene.compile_scene(ref_scene.load_scene(f"scenes/{name}.json.gz"))
    port = scene_arrays_from_numpy(ref.host_copy(), device="cpu")
    host = port.host_copy()
    k_vol = int(np.nonzero(host.sph_vol_grid >= 0)[0][0])
    c, r = host.sph_center[k_vol], float(host.sph_radius[k_vol])
    g = np.random.default_rng(31)
    u = g.normal(size=(B, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    org = (c + u * r * g.uniform(0.0, 1.2, (B, 1))).astype(np.float32)
    d = g.normal(size=(B, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    march = g.uniform(size=B) < 0.7
    last = np.where(g.uniform(size=B) < 0.9, k_vol, 0).astype(np.int32)
    step = 0.3 * r
    cmin = np.where(march, 0.0, 0.01).astype(np.float32)
    cmax = np.where(march, step, 1000.0).astype(np.float32)
    ph = intersect.nearest_hit(tv3(org), tv3(d), torch.from_numpy(cmin),
                               torch.from_numpy(cmax), port, march=torch.from_numpy(march),
                               last_sphere=torch.from_numpy(last))
    rh = ref_isect.nearest_hit(jv3(org), jv3(d), jnp.asarray(cmin), jnp.asarray(cmax), ref,
                               march=jnp.asarray(march), last_sphere=jnp.asarray(last))
    for f in ("valid", "face", "sphere_row", "vol_grid"):
        np.testing.assert_array_equal(getattr(ph, f).numpy(), np.asarray(getattr(rh, f)), f)
    faces = set(ph.face.tolist())
    assert {2, 3, 4} <= faces, faces  # interior, entry and exit events all occur
    ok = ph.valid.numpy()
    np.testing.assert_allclose(ph.t.numpy()[ok], np.asarray(rh.t)[ok], rtol=RTOL, atol=ATOL)
    for f in ("position", "normal", "bbox_min", "bbox_size", "vol_size"):
        for a, b in zip(getattr(ph, f), getattr(rh, f)):
            np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], rtol=RTOL, atol=ATOL,
                                       err_msg=f)


# --- the integrator per lane against the reference ----------------------------

CASES = [("volume", Config(max_bounces=3), 11), ("cloud", Config(max_bounces=3), 11),
         ("dense_cloud", Config(max_bounces=3), 11),
         ("blackhole_cloud", Config(max_bounces=2, volume_step=0.6), 3)]


def _renderers(name, config: Config, output="normal"):
    path = f"scenes/{name}.json.gz"
    ref_s, port_s = ref_scene.load_scene(path), load_scene(path)
    cam = ref_s.find_by_tag("camera")
    for s in (ref_s, port_s):
        s.get_object(cam).inner.aspect_ratio = W / H
    ref = RefRenderer(ref_s, RefConfig(max_bounces=config.max_bounces,
                                       volume_step=config.volume_step,
                                       output=RefOutput(output)), use_pallas=False)
    port = Renderer(port_s, Config(max_bounces=config.max_bounces,
                                   volume_step=config.volume_step, output=Output(output)),
                    device="cpu")
    return ref, port, cam


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def traced(request):
    name, config, seed = request.param
    ref_r, port_r, cam = _renderers(name, config)
    rcfg = ref_r.trace_config(ref_r.config, cam)
    pcfg = port_r.trace_config(port_r.config, cam)
    assert pcfg.has_volumes and rcfg.has_volumes and rcfg.regen_every == 1
    assert pcfg.max_iters(2) == rcfg.max_iters(2)
    ref = ref_trace(ref_r.arrays, ref_r.camera_params(cam),
                    ref_key(jnp.uint32(seed), jnp.uint32(0)),
                    jnp.arange(W * H, dtype=jnp.uint32), jnp.zeros(W * H, jnp.uint32),
                    W, H, 2, 1, rcfg)
    port = trace_core(port_r.arrays, port_r.camera_params(cam), render_key(seed, 0),
                      torch.arange(W * H), torch.zeros(W * H, dtype=torch.int64),
                      W, H, 2, 1, pcfg)
    return ref, port, pcfg


def test_volume_trace_core_matches_xla_per_lane(traced):
    ref, port, cfg = traced
    pairs = [(f"{f}.{c}", getattr(getattr(port, f), c), getattr(getattr(ref, f), c))
             for f in ("radiance", "aov_albedo", "aov_normal") for c in "xyz"]
    pairs.append(("aov_depth", port.aov_depth, ref.aov_depth))
    for name, a, b in pairs:
        a, b = a.numpy(), np.asarray(b)
        off = ~(np.abs(a - b) <= ATOL + RTOL * np.abs(b))
        assert off.sum() <= W * H // 128, f"{name}: {int(off.sum())} lanes off"
        if name.startswith("radiance"):
            assert not off.any(), f"{name}: {int(off.sum())} lanes off"
        assert abs(a.mean() - b.mean()) < 5e-3, name
    assert port.rays.dtype == torch.int64
    assert abs(int(port.rays) - int(ref.rays)) <= 1e-3 * int(ref.rays)
    assert 0 < int(port.vol_events) < int(port.rays)  # the path marched
    assert float(np.asarray(ref.radiance.x).sum()) > 0.0


def test_volume_golden():
    scene = load_scene("scenes/volume.json.gz")
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = 1.0
    r = Renderer(scene, Config(max_bounces=3), device="cpu")
    film = Film(16, 16)
    r.render(cam, RenderConfig(samples=8, subsample=Subsample(1)), film, seed=7)
    golden = np.load("tests/golden/volume_16x16_mb3_s8_seed7.npy")
    off = (np.abs(film.mean() - golden) > 1e-6 + 1e-5 * np.abs(golden)).any(axis=-1)
    assert off.sum() <= 16, f"{int(off.sum())} pixels off"
    assert abs(film.mean().mean() - golden.mean()) < 5e-3


def test_row_chunking_and_cpu_dispatch():
    """Any row chunking renders the same cloud image with the same rays;
    the tracer's CPU route is the plain trace_core, bit for bit; the
    kernel wrappers take CUDA tensors only and refuse configurations that
    are not theirs."""
    scene = load_scene("scenes/cloud.json.gz")
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = 1.0
    rc = RenderConfig(samples=2, subsample=Subsample(2))
    whole, chunked = Film(W, H), Film(W, H)
    r1 = Renderer(scene, Config(max_bounces=3), device="cpu")
    r1.render(cam, rc, whole, seed=3)
    r2 = Renderer(scene, Config(max_bounces=3), max_lanes=W * 4 * 3, device="cpu")
    r2.render(cam, rc, chunked, seed=3)
    np.testing.assert_array_equal(chunked.sum, whole.sum)
    assert r2.rays_traced == r1.rays_traced > 0

    cfg = r1.trace_config(r1.config, cam)
    pix = torch.arange(W * H, dtype=torch.int32)
    sub = torch.zeros(W * H, dtype=torch.int32)
    res = make_tracer(r1.arrays, W, H, 1, 1, cfg)(r1._cam_packed, 3, 0, pix, sub)
    plain = trace_core(r1.arrays, r1.camera_params(cam), render_key(3, 0), pix, sub,
                       W, H, 1, 1, cfg)
    assert torch.equal(res.radiance.x, plain.radiance.x)
    assert (int(res.rays), int(res.iters), int(res.vol_events)) == \
        (int(plain.rays), int(plain.iters), int(plain.vol_events))
    table_np, counts = scene_table(r1.arrays.host_copy())
    table = torch.from_numpy(table_np)
    kw = dict(width=W, height=H, spp=1, spp_total=1, subsample=1, key=(1, 2), sample0=0, cfg=cfg)
    with pytest.raises(ValueError, match="CUDA"):
        trace_volume(table, counts, r1._cam_packed.reshape(-1), pix, sub,
                     r1.arrays.vol_grid.contiguous(), **kw)
    for wrapper in (trace_surface, trace_geodesic):
        with pytest.raises(ValueError, match="trace_volume"):
            wrapper(table, counts, r1._cam_packed.reshape(-1), pix, sub, **kw)


@pytest.mark.parametrize("name", ["dense_cloud", "blackhole_cloud"])
def test_model_builders_dump_byte_equal(name):
    ours = getattr(bendy_tpu_torch, f"build_{name}")()
    theirs = ref_dense.build_dense_cloud() if name == "dense_cloud" else ref_build_bhc()
    assert dumps_scene(ours) == ref_scene.dumps_scene(theirs)
