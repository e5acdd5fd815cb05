"""Port parity for kernel 1a's module: the plain integrator and its glue.

``bendy_tpu_torch.ops.wavefront.trace_core`` is the plain version of the
CUDA tracer (csrc/trace_surface.cu). It is held lane by lane to the
reference's XLA path ``bendy_tpu.ops.wavefront.trace`` — the yardstick
tests/test_pallas.py holds the TPU kernel to — at 16x16, 4 spp,
max_bounces=3, seed 7: rtol 5e-4, atol 1e-5 per lane and equal ray counts.
The kernel itself needs a card; chip_smoke.py holds it to this plain
version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bendy_tpu.ops.intersect import prim_tables
from bendy_tpu.ops.wavefront import trace as ref_trace
from bendy_tpu.render import Config as RefConfig
from bendy_tpu.render import Output as RefOutput
from bendy_tpu.render import Renderer as RefRenderer
from bendy_tpu.scene import load_scene as ref_load
from bendy_tpu.utils.rng import render_key as ref_key
from bendy_tpu_torch import Config, Output, Renderer, load_scene
from bendy_tpu_torch.ops.trace_kernel import make_tracer, scene_table
from bendy_tpu_torch.ops.wavefront import TraceConfig, trace_core
from bendy_tpu_torch.utils.rng import render_key
from torch_threads import one_intra_op_thread  # noqa: F401

W = H = 16
SPP = 4
SEED = 7
CASES = [("cornell", "full"), ("cornell2", "full"), ("scene", "full"), ("cornell", "normal")]


def _renderers(name, output):
    path = f"scenes/{name}.json.gz"
    ref_scene = ref_load(path)
    port_scene = load_scene(path)
    cam = ref_scene.find_by_tag("camera")
    for s in (ref_scene, port_scene):
        s.get_object(cam).inner.aspect_ratio = W / H
    ref = RefRenderer(ref_scene, RefConfig(max_bounces=3, output=RefOutput(output)),
                      use_pallas=False)
    port = Renderer(port_scene, Config(max_bounces=3, output=Output(output)), device="cpu")
    return ref, port, cam


@pytest.fixture(scope="module", params=CASES, ids=["-".join(c) for c in CASES])
def traced(request):
    ref_r, port_r, cam = _renderers(*request.param)
    rcfg = ref_r.trace_config(ref_r.config, cam)
    pcfg = port_r.trace_config(port_r.config, cam)
    for f in ("max_bounces", "frustum_poly", "has_diffuse", "has_metallic",
              "has_glass", "has_dof", "want_aovs"):
        assert getattr(pcfg, f) == getattr(rcfg, f), f
    assert rcfg.regen_every == 1  # the reference's CPU cadence, as the port's
    pix = jnp.arange(W * H, dtype=jnp.uint32)
    sub = jnp.zeros(W * H, jnp.uint32)
    ref = ref_trace(ref_r.arrays, ref_r.camera_params(cam),
                    ref_key(jnp.uint32(SEED), jnp.uint32(0)), pix, sub, W, H, SPP, 1, rcfg)
    port = trace_core(port_r.arrays, port_r.camera_params(cam), render_key(SEED, 0),
                      torch.arange(W * H), torch.zeros(W * H, dtype=torch.int64),
                      W, H, SPP, 1, pcfg)
    return ref, port, pcfg


def test_trace_core_matches_xla_per_lane(traced):
    ref, port, cfg = traced
    chans = [("radiance", "xyz")]
    if cfg.want_aovs:
        chans += [("aov_albedo", "xyz"), ("aov_normal", "xyz")]
    for field, comps in chans:
        for c in comps:
            np.testing.assert_allclose(
                getattr(getattr(port, field), c).numpy(),
                np.asarray(getattr(getattr(ref, field), c)),
                rtol=5e-4, atol=1e-5, err_msg=f"{field}.{c}",
            )
    if cfg.want_aovs:
        np.testing.assert_allclose(port.aov_depth.numpy(), np.asarray(ref.aov_depth),
                                   rtol=5e-4, atol=1e-5)
    assert port.rays.dtype == torch.int64
    assert int(port.rays) == int(ref.rays)  # exact: f32 is exact at this size
    assert float(np.asarray(ref.radiance.x).sum()) > 0.0  # something was lit


def test_stream_id_space_refused():
    _, port_r, cam = _renderers("cornell", "full")
    cfg = port_r.trace_config(port_r.config, cam)
    lanes = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="exceeds u32"):
        trace_core(port_r.arrays, port_r.camera_params(cam), (1, 2), lanes, lanes,
                   4096, 2160, 256, 2, cfg)
    with pytest.raises(ValueError, match="exceeds u32"):
        make_tracer(port_r.arrays, 4096, 2160, 256, 2, cfg)


@pytest.mark.parametrize("flag", ["has_volumes", "geodesic", "looped_sweep",
                                  "looped_lights", "looped_masses"])
def test_unported_modes_refused(flag):
    """Nothing is refused any more: every mode traces on the CPU with
    finite radiance and rays > 0. Media alone ([has_volumes]) and under
    geodesics ([geodesic], blackhole_cloud's mode) trace, and so do the
    looped sweeps on top of them (cloud_field's looped_sweep, mass_cluster's
    looped_masses), as the looped flags alone do on a flat scene."""
    _, port_r, cam = _renderers("cornell", "full")
    lanes = torch.zeros(4, dtype=torch.int64)
    flags = {flag: True}
    if flag in ("has_volumes", "geodesic"):
        flags = {"has_volumes": True, "geodesic": flag == "geodesic"}
        res = trace_core(port_r.arrays, port_r.camera_params(cam), (1, 2), lanes, lanes,
                         4, 1, 1, 1, TraceConfig(**flags))
        assert int(res.rays) > 0 and torch.isfinite(res.radiance.x).all()
        flags["looped_masses" if flag == "geodesic" else "looped_sweep"] = True
    res = trace_core(port_r.arrays, port_r.camera_params(cam), (1, 2), lanes, lanes,
                     4, 1, 1, 1, TraceConfig(**flags))
    assert int(res.rays) > 0 and torch.isfinite(res.radiance.x).all()


def test_active_mask_and_cpu_tracer_dispatch():
    _, port_r, cam = _renderers("cornell", "full")
    cfg = port_r.trace_config(port_r.config, cam)
    port_r.camera_params(cam)
    pix = torch.arange(W * H, dtype=torch.int32)
    sub = torch.zeros(W * H, dtype=torch.int32)
    # the tracer's CPU route is the plain version, bit for bit
    res = make_tracer(port_r.arrays, W, H, 2, 1, cfg)(port_r._cam_packed, SEED, 0, pix, sub)
    plain = trace_core(port_r.arrays, port_r.camera_params(cam), render_key(SEED, 0),
                       pix, sub, W, H, 2, 1, cfg)
    assert torch.equal(res.radiance.x, plain.radiance.x) and int(res.rays) == int(plain.rays)
    # padding lanes (active=False) trace nothing and count no rays
    active = torch.arange(W * H) % 3 != 0
    masked = trace_core(port_r.arrays, port_r.camera_params(cam), render_key(SEED, 0),
                        pix, sub, W, H, 2, 1, cfg, active=active)
    assert torch.equal(masked.radiance.x[active], plain.radiance.x[active])
    assert torch.all(masked.radiance.x[~active] == 0)
    assert 0 < int(masked.rays) < int(plain.rays)
    with pytest.raises(ValueError, match="no tracer"):
        make_tracer(port_r.arrays, W, H, 2, 1, cfg)(
            port_r._cam_packed, SEED, 0, pix.to("meta"), sub.to("meta"))


def test_iters_are_per_lane_loop_lengths():
    """``iters`` sums each lane's own loop length (as the kernel counts it),
    so it adds up over lane subsets and padding lanes contribute nothing."""
    _, port_r, cam = _renderers("cornell", "full")
    cfg = port_r.trace_config(port_r.config, cam)
    params = port_r.camera_params(cam)
    pix = torch.arange(W * H, dtype=torch.int32)
    sub = torch.zeros(W * H, dtype=torch.int32)

    def run(p, s, **kw):
        return trace_core(port_r.arrays, params, render_key(SEED, 0), p, s, W, H, 2, 1, cfg, **kw)

    whole = run(pix, sub)
    half = W * H // 2
    lo, hi = run(pix[:half], sub[:half]), run(pix[half:], sub[half:])
    assert int(whole.iters) == int(lo.iters) + int(hi.iters)
    assert int(whole.rays) <= int(whole.iters) <= W * H * cfg.max_iters(2)
    active = torch.arange(W * H) % 3 != 0
    masked = run(pix, sub, active=active)
    assert int(masked.iters) == int(run(pix[active], sub[active]).iters)


@pytest.mark.parametrize("name", ["cornell", "cornell2", "scene", "binary_blackhole"])
def test_scene_table_layout_is_prim_tables(name):
    """The kernel's flat table is the reference's prim_tables row layout,
    unpadded, then the light rows, the environment and the mass rows."""
    host = load_scene(f"scenes/{name}.json.gz")
    from bendy_tpu_torch.scene.compiler import compile_scene

    arrays = compile_scene(host, device="cpu").host_copy()
    table, counts = scene_table(arrays)
    ref = prim_tables(arrays, np, block=1)
    parts = [ref.get(k, np.zeros((0, n), np.float32))
             for k, n in (("sph", 15), ("rct", 21), ("box", 28))] + [ref["light"]]
    flat = np.concatenate([p.reshape(-1) for p in parts])
    np.testing.assert_array_equal(table[:flat.size], flat)
    env = np.concatenate([[arrays.root_mtype], arrays.root_albedo, arrays.root_emitted])
    mass = np.concatenate([arrays.mass_center, arrays.mass_rs[:, None]], axis=1)
    np.testing.assert_array_equal(table[flat.size:],
                                  np.concatenate([env, mass.reshape(-1)]).astype(np.float32))
    assert counts == dict(n_sph=arrays.sph_radius.shape[0], n_rct=arrays.rct_traced.shape[0],
                          n_box=arrays.box_rough.shape[0], n_light=arrays.light_kind.shape[0],
                          n_face=arrays.light_face_cdf.shape[1],
                          n_mass=arrays.mass_rs.shape[0])


def test_packed_camera_and_aux_match_reference():
    from bendy_tpu.ops import pallas_trace as ref_pack
    from bendy_tpu_torch.ops import trace_kernel as port_pack

    g = np.random.default_rng(3)
    args = (*g.uniform(0.1, 5.0, 6), g.normal(size=(3, 3)), g.normal(size=3))
    np.testing.assert_array_equal(port_pack.pack_camera_host(*args),
                                  ref_pack.pack_camera_host(*args))
    key = (2**31 + 7, 12345)
    np.testing.assert_array_equal(port_pack.pack_aux(key, 64, 1000),
                                  np.asarray(ref_pack.pack_aux(key, 64, 1000)))
    cam = port_pack.unpack_camera(torch.from_numpy(port_pack.pack_camera_host(*args)))
    np.testing.assert_array_equal(cam.rotation.numpy(), np.float32(args[6]))
    assert float(cam.yfov) == np.float32(args[5])
