"""Port parity for kernel 1d's modules: geodesic propagation (CPU).

``bendy_tpu_torch.geodesic`` and the geodesic mode of
``bendy_tpu_torch.ops.wavefront.trace_core`` are the plain version of the
CUDA tracer's geodesic instantiation (csrc/trace_surface.cu); chip_smoke.py
holds the kernel to them on a card. Here they are held to ``bendy_tpu``:

- the geodesic functions on 512 seeded random lanes against three mass
  tables (1 mass of rs 0.5, blackhole, binary_blackhole): masks equal, ds
  and h² within rtol 1e-6, the RK4 step, acceleration, step size within
  rtol 1e-5 / atol 1e-7;
- the analytic physics gates of tests/test_geodesic.py on the port's own
  functions, each batched into one multi-lane run;
- the integrator per lane against the XLA ``trace`` on blackhole and
  binary_blackhole (16x16, max_bounces 2, seed 3; spp 1 and 4; FULL and
  NORMAL), at rtol 5e-4 / atol 1e-5 on every channel of every lane, with
  equal ray counts. No lane flips between capture and escape at these
  inputs, so none is allowed to;
- the Renderer film, the trace configuration of every bundled scene
  (volume knobs included) and of three generated ones, the scenes that
  were refused before the looped sweeps (they render now) and the model
  builders.
"""

import glob
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bendy_tpu.geodesic as ref_geo
import bendy_tpu.models as ref_models
import bendy_tpu.scene as ref_scene
from bendy_tpu.film import Film as RefFilm
from bendy_tpu.models.mass_cluster import build_mass_cluster as ref_build_mass_cluster
from bendy_tpu.models.prim_grid import build_light_field as ref_build_light_field
from bendy_tpu.models.prim_grid import build_prim_grid as ref_build_prim_grid
from bendy_tpu.ops import intersect as ref_isect
from bendy_tpu.ops.wavefront import trace as ref_trace
from bendy_tpu.render import Config as RefConfig
from bendy_tpu.render import Output as RefOutput
from bendy_tpu.render import RenderConfig as RefRenderConfig
from bendy_tpu.render import Renderer as RefRenderer
from bendy_tpu.render import Subsample as RefSubsample
from bendy_tpu.utils.rng import render_key as ref_key
from bendy_tpu.utils.v3 import V3 as JV3
import bendy_tpu_torch
from bendy_tpu_torch import geodesic as geo
from bendy_tpu_torch import (
    Config,
    Film,
    GeoParams,
    Output,
    RenderConfig,
    Renderer,
    Subsample,
    dumps_scene,
    load_scene,
)
from bendy_tpu_torch.ops import intersect
from bendy_tpu_torch.ops.trace_kernel import make_tracer
from bendy_tpu_torch.ops.wavefront import trace_core
from bendy_tpu_torch.scene.compiler import scene_arrays_from_numpy
from bendy_tpu_torch.utils.rng import render_key
from bendy_tpu_torch.utils.v3 import V3
from torch_threads import one_intra_op_thread  # noqa: F401

W = H = 16
SEED = 3
RTOL, ATOL = 5e-4, 1e-5
B = 512


def jv3(a):
    return JV3(*(jnp.asarray(a[:, i]) for i in range(3)))


def tv3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def mass_scene(pkg, rs: float):
    """One mass at the origin and a dummy light (tests/test_geodesic.py)."""
    scene = pkg.Scene()
    scene.add_object(pkg.Object().with_tag(f"mass:{rs}"))
    mat = scene.add_data(pkg.Data(pkg.Material.emissive((1, 1, 1), 1.0)))
    scene.add_object(
        pkg.Object(pkg.Sphere(material=mat, radius=0.1)).with_translation([0, 0, 500.0])
        .with_flags(pkg.ObjectFlags.LIGHT)
    )
    return scene


def port_mass_tables(rs: float):
    return bendy_tpu_torch.compile_scene(mass_scene(bendy_tpu_torch, rs), device="cpu")


# --- the geodesic functions, lane by lane -----------------------------------

@pytest.fixture(scope="module", params=["mass", "blackhole", "binary_blackhole"])
def lanes(request):
    """Both packages' tables and 512 seeded (x, d, steps) lanes spread from
    inside the horizons out past the far-field radius."""
    if request.param == "mass":
        ref = ref_scene.compile_scene(mass_scene(ref_scene, 0.5))
    else:
        ref = ref_scene.compile_scene(ref_scene.load_scene(f"scenes/{request.param}.json.gz"))
    port = scene_arrays_from_numpy(ref.host_copy(), device="cpu")
    host = ref.host_copy()
    g = np.random.default_rng(17)
    k = g.integers(0, host.mass_rs.shape[0], B)
    rs = host.mass_rs[k][:, None]
    u = g.normal(size=(B, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = rs * np.exp(g.uniform(np.log(0.5), np.log(120.0), (B, 1)))
    x = (host.mass_center[k] + u * r).astype(np.float32)
    d = g.normal(size=(B, 3)) * g.uniform(0.5, 1.5, (B, 1))
    steps = g.integers(0, 300, B).astype(np.int32)
    return ref, port, x, d.astype(np.float32), steps


def _close(a, b, rtol=1e-5, atol=1e-7, msg=""):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol, err_msg=msg)


def test_geo_step_begin_matches(lanes):
    ref, port, x, d, steps = lanes
    p = GeoParams()
    rc, rf, rds, rh2 = ref_geo.geo_step_begin(ref, jv3(x), jv3(d), ref_geo.GeoParams(),
                                              steps=jnp.asarray(steps))
    pc, pf, pds, ph2 = geo.geo_step_begin(port, tv3(x), tv3(d), p,
                                          steps=torch.from_numpy(steps))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(rf))
    assert pc.any() and pf.any() and not pf.all()  # the lanes reach both tests
    _close(pds, rds, rtol=1e-6, atol=0.0, msg="ds")
    assert len(ph2) == len(rh2) == port.n_masses
    for a, b in zip(ph2, rh2):
        _close(a, b, rtol=1e-6, atol=0.0, msg="h2")


def test_rk4_and_helpers_match(lanes):
    ref, port, x, d, steps = lanes
    jx, jd, tx, td = jv3(x), jv3(d), tv3(x), tv3(d)
    _, _, rds, rh2 = ref_geo.geo_step_begin(ref, jx, jd, ref_geo.GeoParams())
    _, _, pds, ph2 = geo.geo_step_begin(port, tx, td, GeoParams())
    for h2s in (None, "frozen"):
        rx, rd = ref_geo.rk4_step(ref, jx, jd, rds, h2s=rh2 if h2s else None)
        px, pd = geo.rk4_step(port, tx, td, pds, h2s=ph2 if h2s else None)
        for a, b in zip((*px, *pd), (*rx, *rd)):
            _close(a, b, msg=f"rk4 h2s={h2s}")
    for a, b in zip(geo.acceleration(port, tx, td), ref_geo.acceleration(ref, jx, jd)):
        _close(a, b, msg="acceleration")
    p = GeoParams(eta=0.1, growth=0.05)
    _close(geo.step_size(port, tx, p, torch.from_numpy(steps)),
           ref_geo.step_size(ref, jx, ref_geo.GeoParams(eta=0.1, growth=0.05),
                             jnp.asarray(steps)), msg="step_size")
    pc, pf = geo.capture_and_far(port, tx, td, GeoParams())
    rc, rf = ref_geo.capture_and_far(ref, jx, jd, ref_geo.GeoParams())
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(rf))


def test_per_lane_clip_matches_scalar_clip_and_reference():
    """nearest_hit with per-lane [B] clip tensors picks the same winners as
    the scalar-clip path on each lane's clip, and as the reference does
    with the same per-lane clips."""
    path = "scenes/blackhole.json.gz"
    ref = ref_scene.compile_scene(ref_scene.load_scene(path))
    port = scene_arrays_from_numpy(ref.host_copy(), device="cpu")
    g = np.random.default_rng(23)
    org = g.uniform(-12.0, 12.0, (B, 3)).astype(np.float32)
    target = port.host_copy().sph_center[g.integers(0, port.n_spheres, B)]
    d = target - org + g.normal(scale=0.5, size=(B, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    clips = [(0.01, 1000.0), (0.0, 25.0), (0.01, 40.0)]
    pick = g.integers(0, len(clips), B)
    cmin = np.array([clips[i][0] for i in pick], np.float32)
    cmax = np.array([clips[i][1] for i in pick], np.float32)
    lane = intersect.nearest_hit(tv3(org), tv3(d), torch.from_numpy(cmin),
                                 torch.from_numpy(cmax), port)
    for i, (lo, hi) in enumerate(clips):
        sel = torch.from_numpy(pick == i)
        scalar = intersect.nearest_hit(tv3(org), tv3(d), lo, hi, port)
        for f in ("t", "valid", "face", "mtype"):
            assert torch.equal(getattr(lane, f)[sel], getattr(scalar, f)[sel]), f
    assert 0 < int(lane.valid.sum()) < B
    rh = ref_isect.nearest_hit(jv3(org), jv3(d), jnp.asarray(cmin), jnp.asarray(cmax), ref,
                               carry_rough=True)
    np.testing.assert_array_equal(lane.valid.numpy(), np.asarray(rh.valid))
    np.testing.assert_array_equal(lane.face.numpy(), np.asarray(rh.face))
    ok = lane.valid.numpy()
    np.testing.assert_allclose(lane.t.numpy()[ok], np.asarray(rh.t)[ok], rtol=RTOL, atol=ATOL)


# --- analytic physics gates (tests/test_geodesic.py) on the port -----------

def _v3(rows):
    a = np.asarray(rows, np.float32)
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _angle(d: V3, axis: str = "y") -> np.ndarray:
    return np.arctan2(-getattr(d, axis).numpy(), d.x.numpy())


def test_weak_field_deflection_scaling_and_frozen_h2():
    """One batched flyby at rs 0.01, ds 0.05, 2600 steps: generic RK4 on
    b = 1, 2, 4 and b = 2 out of plane, frozen-h² RK4 on b = 1. Gates:
    alpha = 2rs/b within 5 %, 1/b scaling within 5 %, rotational symmetry
    and frozen vs generic within 1e-3 relative."""
    rs = 0.01
    scn = port_mass_tables(rs)
    x = _v3([(-60, 1, 0), (-60, 2, 0), (-60, 4, 0), (-60, 0, 2)])
    d = _v3([(1, 0, 0)] * 4)
    xf, df = _v3([(-60, 1, 0)]), _v3([(1, 0, 0)])
    ds, dsf = torch.full((4,), 0.05), torch.full((1,), 0.05)
    for _ in range(2600):
        x, d = geo.rk4_step(scn, x, d, ds)
        _, _, _, h2s = geo.geo_step_begin(scn, xf, df, GeoParams())
        xf, df = geo.rk4_step(scn, xf, df, dsf, h2s=h2s)
    assert (x.x.numpy() > 50.0).all()
    alpha = _angle(d)
    for i, b in enumerate((1.0, 2.0, 4.0)):
        assert alpha[i] == pytest.approx(2.0 * rs / b, rel=0.05), (b, alpha[i])
    assert alpha[1] / alpha[2] == pytest.approx(2.0, rel=0.05)
    assert _angle(d, "z")[3] == pytest.approx(alpha[1], rel=1e-3)
    a_frozen = _angle(df)[0]
    assert a_frozen == pytest.approx(alpha[0], rel=1e-3)
    assert a_frozen == pytest.approx(2.0 * rs, rel=0.05)


def test_flat_limit_rs_zero():
    """rs = 0 leaves rays exactly straight: the acceleration is exactly 0,
    so the f32 state keeps its exact values (atol 1e-12 as the reference's
    gate, met exactly here)."""
    scn = port_mass_tables(0.0)
    x, d = _v3([(-30, 1.5, 0), (-30, 0, -2.5)]), _v3([(1, 0, 0)] * 2)
    ds = torch.full((2,), 0.1)
    for _ in range(600):
        x, d = geo.rk4_step(scn, x, d, ds)
    np.testing.assert_allclose(d.y.numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(d.z.numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(d.x.numpy(), 1.0, atol=1e-12)
    np.testing.assert_allclose(x.y.numpy(), [1.5, 0.0], atol=1e-10)


def test_photon_sphere_capture_threshold():
    """b_crit = (3√3/2)·rs: 0.85·b_crit is captured, 1.25·b_crit escapes."""
    rs = 0.5
    b_crit = 3 * np.sqrt(3) / 2 * rs
    scn = port_mass_tables(rs)
    p = GeoParams(eta=0.02, min_step=0.002, max_step=0.5)
    x = _v3([(-20.0, 0.85 * b_crit, 0.0), (-20.0, 1.25 * b_crit, 0.0)])
    d = _v3([(1, 0, 0)] * 2)
    captured = torch.zeros(2, dtype=torch.bool)
    done = torch.zeros(2, dtype=torch.bool)
    for _ in range(6000):
        x, d = geo.rk4_step(scn, x, d, geo.step_size(scn, x, p))
        cap, _ = geo.capture_and_far(scn, x, d, p)
        captured |= cap & ~done
        done |= cap | ((x.length() > 30.0) & (x.dot(d) > 0))
        if bool(done.all()):
            break
    assert bool(done.all())
    assert captured.tolist() == [True, False]


# --- the integrator per lane against the reference ---------------------------

# each scene meets both spp and both outputs (a full cross would compile the
# reference's loop eight times on the CPU)
CASES = [("blackhole", 1, "full"), ("blackhole", 4, "normal"),
         ("binary_blackhole", 1, "normal"), ("binary_blackhole", 4, "full")]


def _renderers(name, output):
    path = f"scenes/{name}.json.gz"
    ref_s, port_s = ref_scene.load_scene(path), load_scene(path)
    cam = ref_s.find_by_tag("camera")
    for s in (ref_s, port_s):
        s.get_object(cam).inner.aspect_ratio = W / H
    ref = RefRenderer(ref_s, RefConfig(max_bounces=2, output=RefOutput(output)),
                      use_pallas=False)
    port = Renderer(port_s, Config(max_bounces=2, output=Output(output)), device="cpu")
    return ref, port, cam


@pytest.fixture(scope="module", params=CASES, ids=["-".join(map(str, c)) for c in CASES])
def traced(request):
    name, spp, output = request.param
    ref_r, port_r, cam = _renderers(name, output)
    rcfg = ref_r.trace_config(ref_r.config, cam)
    pcfg = port_r.trace_config(port_r.config, cam)
    assert pcfg.geodesic and rcfg.geodesic and rcfg.regen_every == 1
    ref = ref_trace(ref_r.arrays, ref_r.camera_params(cam),
                    ref_key(jnp.uint32(SEED), jnp.uint32(0)),
                    jnp.arange(W * H, dtype=jnp.uint32), jnp.zeros(W * H, jnp.uint32),
                    W, H, spp, 1, rcfg)
    port = trace_core(port_r.arrays, port_r.camera_params(cam), render_key(SEED, 0),
                      torch.arange(W * H), torch.zeros(W * H, dtype=torch.int64),
                      W, H, spp, 1, pcfg)
    return ref, port, pcfg


def test_geodesic_trace_core_matches_xla_per_lane(traced):
    ref, port, cfg = traced
    pairs = [(f"radiance.{c}", getattr(port.radiance, c), getattr(ref.radiance, c))
             for c in "xyz"]
    if cfg.want_aovs:
        pairs += [(f"{f}.{c}", getattr(getattr(port, f), c), getattr(getattr(ref, f), c))
                  for f in ("aov_albedo", "aov_normal") for c in "xyz"]
        pairs.append(("aov_depth", port.aov_depth, ref.aov_depth))
    off = np.zeros(W * H, bool)
    for name, a, b in pairs:
        a, b = a.numpy(), np.asarray(b)
        off |= ~(np.abs(a - b) <= ATOL + RTOL * np.abs(b))
    assert not off.any(), f"lanes off: {np.nonzero(off)[0].tolist()}"
    assert port.rays.dtype == torch.int64
    assert int(port.rays) == int(ref.rays)  # exact: f32 is exact at this size
    assert float(np.asarray(ref.radiance.x).sum()) > 0.0


def test_geodesic_tracer_cpu_route_is_plain():
    """make_tracer's CPU route for a geodesic scene is the plain trace_core,
    bit for bit."""
    _, port_r, cam = _renderers("binary_blackhole", "full")
    cfg = port_r.trace_config(port_r.config, cam)
    port_r.camera_params(cam)
    pix = torch.arange(W * H, dtype=torch.int32)
    sub = torch.zeros(W * H, dtype=torch.int32)
    res = make_tracer(port_r.arrays, W, H, 1, 1, cfg)(port_r._cam_packed, SEED, 0, pix, sub)
    plain = trace_core(port_r.arrays, port_r.camera_params(cam), render_key(SEED, 0),
                       pix, sub, W, H, 1, 1, cfg)
    assert torch.equal(res.radiance.x, plain.radiance.x)
    assert int(res.rays) == int(plain.rays) and int(res.iters) == int(plain.iters)


# --- renderer, configuration, refusals, models -------------------------------

def test_renderer_film_matches_reference_and_chunking():
    scene_p = load_scene("scenes/blackhole.json.gz")
    scene_r = ref_scene.load_scene("scenes/blackhole.json.gz")
    cam = scene_p.find_by_tag("camera")
    for s in (scene_p, scene_r):
        s.get_object(cam).inner.aspect_ratio = 1.0
    ref_r = RefRenderer(scene_r, RefConfig(max_bounces=2), use_pallas=False)
    port_r = Renderer(scene_p, Config(max_bounces=2), device="cpu")
    chunked_r = Renderer(scene_p, Config(max_bounces=2), max_lanes=W * 5, device="cpu")
    ref_f, port_f, chunk_f = RefFilm(W, H), Film(W, H), Film(W, H)
    for _ in range(2):
        ref_r.render(cam, RefRenderConfig(samples=2, subsample=RefSubsample(1)), ref_f, seed=SEED)
        for r, f in ((port_r, port_f), (chunked_r, chunk_f)):
            r.render(cam, RenderConfig(samples=2, subsample=Subsample(1)), f, seed=SEED)
    np.testing.assert_allclose(port_f.mean(), ref_f.mean(), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(chunk_f.sum, port_f.sum)
    assert chunked_r.rays_traced == port_r.rays_traced == int(ref_r.rays_traced)
    assert port_f.mean().mean() > 0.0


SCENES = sorted(glob.glob("scenes/*.json.gz"))
# generated scenes past each loop threshold: primitives, lights, masses
GENERATED = {"build_prim_grid(200)": (ref_build_prim_grid, 200),
             "build_light_field(72)": (ref_build_light_field, 72),
             "build_mass_cluster(12)": (ref_build_mass_cluster, 12)}
FIELDS = ("geodesic", "geo", "looped_masses", "has_volumes", "has_diffuse", "has_metallic",
          "has_glass", "frustum_poly", "has_dof", "want_aovs", "max_volume_bounces",
          "volume_step", "vol_nearest", "looped_sweep", "looped_lights")


@pytest.mark.parametrize("path", SCENES + list(GENERATED))
def test_trace_config_matches_reference(path):
    if path in GENERATED:
        ref_build, n = GENERATED[path]
        ref_s, port_s = ref_build(n), getattr(bendy_tpu_torch, ref_build.__name__)(n)
    else:
        ref_s, port_s = ref_scene.load_scene(path), load_scene(path)
    cam = ref_s.find_by_tag("camera")
    explicit = GeoParams(eta=0.1, max_steps=512)
    media = dict(volume_step=0.6, max_volume_bounces=16, vol_sampling="nearest")
    for geo_cfg in (None, explicit):
        # the explicit case also sets every volume knob off its default
        kw = {} if geo_cfg is None else media
        ref_r = RefRenderer(ref_s, RefConfig(geo=None if geo_cfg is None
                                             else ref_geo.GeoParams(*geo_cfg), **kw),
                            use_pallas=False)
        port_r = Renderer(port_s, Config(geo=geo_cfg, **kw), device="cpu")
        rc = ref_r.trace_config(ref_r.config, cam)
        pc = port_r.trace_config(port_r.config, cam)
        for f in FIELDS:
            assert getattr(pc, f) == getattr(rc, f), f
        assert pc.max_iters(4) == rc.max_iters(4)
    # the precedence: explicit Config.geo > the scene file's block > defaults
    if ref_s.geodesic:
        assert port_r.trace_config(port_r.config).geo == explicit
        assert Renderer(port_s, device="cpu").trace_config(Config()).geo == \
            geo.geo_from_dict(ref_s.geodesic)


@pytest.mark.parametrize("name,flag", [("mass_cluster", "looped_masses"),
                                       ("blackhole_cloud", "has_volumes")])
def test_unported_geodesic_scenes_refused(name, flag):
    """Neither scene is refused any more. mass_cluster (more than 8 masses:
    the looped mass sweep) and blackhole_cloud (geodesics inside media)
    render through the Renderer on the CPU; blackhole_cloud's
    configuration also traces with the looped primitive sweep on top
    (cloud_field's), and make_tracer builds for both."""
    scene = load_scene(f"scenes/{name}.json.gz")
    cam = scene.find_by_tag("camera")
    r = Renderer(scene, device="cpu")
    cfg = r.trace_config(r.config, cam)
    assert cfg.geodesic and getattr(cfg, flag)
    lanes = torch.zeros(4, dtype=torch.int64)
    film = Film(4, 4)
    r.render(cam, RenderConfig(samples=1), film)
    assert np.isfinite(film.mean()).all() and r.rays_traced > 0
    if flag == "has_volumes":
        cfg = replace(cfg, looped_sweep=True)
    res = trace_core(r.arrays, r.camera_params(cam), (1, 2), lanes, lanes, 4, 1, 1, 1, cfg)
    assert int(res.rays) > 0 and torch.isfinite(res.radiance.x).all()
    make_tracer(r.arrays, 4, 1, 1, 1, cfg)


def test_renderer_defaults_to_the_card():
    """Entry points run on the card unless asked for the CPU: without a
    card the defaults raise instead of rendering on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the card-less refusal")
    scene = load_scene("scenes/blackhole.json.gz")
    with pytest.raises(RuntimeError, match="cuda"):
        Renderer(scene)
    with pytest.raises(RuntimeError, match="cuda"):
        bendy_tpu_torch.compile_scene(scene)
    host = bendy_tpu_torch.compile_scene(scene, device="cpu").host_copy()
    with pytest.raises(RuntimeError, match="cuda"):
        scene_arrays_from_numpy(host)


@pytest.mark.parametrize("name", ["cornell", "blackhole", "binary_blackhole"])
def test_model_builders_dump_byte_equal(name):
    ours = getattr(bendy_tpu_torch, f"build_{name}")()
    theirs = getattr(ref_models, f"build_{name}")()
    assert dumps_scene(ours) == ref_scene.dumps_scene(theirs)
