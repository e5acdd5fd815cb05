"""Port parity for kernel 1e-i and 1e-ii: the looped primitive and light
sweeps, and the prim_grid repair (CPU).

On Hopper the reference's looped sweeps need no arithmetic of their own:
the plain ``nearest_hit``, ``light_pdf`` and ``sample_light_point`` serve
any count, and the CUDA tracer sweeps the same rows with run-time loops
(chip_smoke.py holds it to them on a card). Here they are held to
``bendy_tpu``, whose looped and unrolled sweeps agree bit for bit
(tests/test_looped_sweep.py).

The prim_grid fault. On ``build_prim_grid(24)`` (16x16, spp 2,
max_bounces 4, seed 7, NORMAL) the port left 4 lanes of radiance and 8 of
the normal AOV outside rtol 5e-4 / atol 1e-5 of the XLA ``trace``, with 1,112
rays against 1,108. The first quantity that differs is the camera ray's
direction, in ``V3.normalize`` (``camera_ray``'s
``rotate(...).normalize()``), where two operations round otherwise:

- the port's: ``torch.sqrt`` on the CPU is not correctly rounded (with
  AVX-512 kernels about 0.7 % of random f32 inputs come out one ulp off;
  the CUDA tracer's ``sqrtf`` and ``jnp.sqrt`` are correctly rounded).
  Repaired: the plain version takes ``utils.v3.sqrt_rn`` everywhere. It
  also moved mass_cluster: 19 of 256 lanes differed from the eagerly run
  reference before, none after;
- the reference's: it normalizes with ``jax.lax.rsqrt``, which XLA's CPU
  backend computes within 2 ulp of 1/sqrt, not correctly rounded (about a
  third of inputs differ), and under jit it contracts the camera rotation's
  multiply-adds (lane 97's direction differs in y). The CUDA kernel cannot
  copy either; it is the rounding class tests/test_torch_volume.py
  documents.

So the tests hold the port two ways: bit for bit against the reference run
eagerly (``jax.disable_jit()``) with its rsqrt replaced by 1/sqrt, the
tight budget, which the tree before the repair missed on prim_grid(24)
(2 lanes not bit-equal); and against the reference as it runs, within a
stated budget, printing the lanes off. At 32x32 that is 12 lanes of 1,024
in radiance and 19 in the normal AOV (above the reference's own 1/128
between its two kernels), rays 4,613 against 4,611; grazing hits on many
small spheres turn the ulps into visible t (|oc|² − r² and the
discriminant cancel). The budget is 1/32 of the lanes per channel, image
means within 5e-3, rays within 0.1 %.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bendy_tpu.scene as ref_scene
import bendy_tpu.utils.v3 as ref_v3
from bendy_tpu.models.cloud_field import build_cloud_field as ref_build_cloud_field
from bendy_tpu.models.prim_grid import build_cuboid_light as ref_build_cuboid_light
from bendy_tpu.models.prim_grid import build_light_field as ref_build_light_field
from bendy_tpu.models.prim_grid import build_prim_grid as ref_build_prim_grid
from bendy_tpu.ops import camera as ref_camera
from bendy_tpu.ops.wavefront import trace as ref_trace
from bendy_tpu.render import Config as RefConfig
from bendy_tpu.render import Output as RefOutput
from bendy_tpu.render import Renderer as RefRenderer
from bendy_tpu.utils.rng import render_key as ref_key
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
from bendy_tpu_torch.ops import camera
from bendy_tpu_torch.ops.wavefront import trace_core
from bendy_tpu_torch.utils.rng import render_key
from bendy_tpu_torch.utils.v3 import sqrt_rn
from torch_threads import one_intra_op_thread  # noqa: F401

RTOL, ATOL = 5e-4, 1e-5
CHANNELS = ("radiance", "aov_albedo", "aov_normal")


def _pair(name: str):
    """The reference's and the port's scene ``name``: a bundled file, or
    ``builder:n`` for a generated one."""
    if ":" not in name:
        path = f"scenes/{name}.json.gz"
        return ref_scene.load_scene(path), load_scene(path)
    builder, n = name.split(":")
    ref_build = {"prim_grid": ref_build_prim_grid, "light_field": ref_build_light_field}[builder]
    return ref_build(int(n)), getattr(bendy_tpu_torch, f"build_{builder}")(int(n))


def _traced(name, W, spp, mb, seed, force_looped=False, eager=False):
    """(reference TraceSums, port TraceSums, port config) at W x W, NORMAL
    output. ``force_looped`` turns the reference's looped sweeps on;
    ``eager`` runs it without jit and with 1/sqrt in place of its rsqrt."""
    ref_s, port_s = _pair(name)
    cam = ref_s.find_by_tag("camera")
    for s in (ref_s, port_s):
        s.get_object(cam).inner.aspect_ratio = 1.0
    ref_r = RefRenderer(ref_s, RefConfig(max_bounces=mb, output=RefOutput.NORMAL),
                        use_pallas=False)
    port_r = Renderer(port_s, Config(max_bounces=mb, output=Output.NORMAL), device="cpu")
    rcfg = ref_r.trace_config(ref_r.config, cam)
    pcfg = port_r.trace_config(port_r.config, cam)
    if force_looped:
        rcfg = rcfg._replace(looped_sweep=True, looped_lights=True)
    args = (ref_r.arrays, ref_r.camera_params(cam), ref_key(jnp.uint32(seed), jnp.uint32(0)),
            jnp.arange(W * W, dtype=jnp.uint32), jnp.zeros(W * W, jnp.uint32), W, W, spp, 1,
            rcfg)
    if eager:
        with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
            mp.setattr(ref_v3, "jax_rsqrt", lambda x: 1.0 / jnp.sqrt(x))
            ref = ref_trace(*args)
    else:
        ref = ref_trace(*args)
    port = trace_core(port_r.arrays, port_r.camera_params(cam), render_key(seed, 0),
                      torch.arange(W * W), torch.zeros(W * W, dtype=torch.int64), W, W, spp,
                      1, pcfg)
    return ref, port, pcfg


def _lanes_off(ref, port) -> dict:
    """Per channel: the count of lanes outside rtol/atol, the count not
    bit-equal, and the difference of the image means."""
    res = {}
    for f in CHANNELS:
        off = neq = mean = 0
        for c in "xyz":
            a = getattr(getattr(port, f), c).numpy()
            b = np.asarray(getattr(getattr(ref, f), c))
            off = off | ~(np.abs(a - b) <= ATOL + RTOL * np.abs(b))
            neq = neq | (a != b)
            mean = max(mean, abs(float(a.mean()) - float(b.mean())))
        res[f] = (int(off.sum()), int(neq.sum()), mean)
    return res


# --- step 0: the prim_grid fault ----------------------------------------------

def test_prim_grid_fault_first_op_is_the_camera_normalize():
    """build_prim_grid(24): sqrt_rn rounds as numpy's correctly rounded
    sqrt (torch.sqrt on the CPU may not); with it the port's camera rays
    equal the reference's bit for bit once the reference normalizes by
    1/sqrt, and differ where it normalizes by XLA's rsqrt."""
    g = np.random.default_rng(5)
    x = np.exp(g.uniform(-20.0, 20.0, 200_000)).astype(np.float32)
    exact = np.sqrt(x)
    np.testing.assert_array_equal(sqrt_rn(torch.from_numpy(x)).numpy(), exact)
    print(f"torch.sqrt off the correctly rounded sqrt: "
          f"{int((torch.sqrt(torch.from_numpy(x)).numpy() != exact).sum())} of {x.size}")

    W = 16
    ref_s, port_s = _pair("prim_grid:24")
    cam = ref_s.find_by_tag("camera")
    for s in (ref_s, port_s):
        s.get_object(cam).inner.aspect_ratio = 1.0
    ref_r = RefRenderer(ref_s, RefConfig(), use_pallas=False)
    port_r = Renderer(port_s, device="cpu")
    pix = np.arange(W * W)
    sid = pix * 2  # sample 0 of 2
    px, py = (pix % W).astype(np.float32), (pix // W).astype(np.float32)
    zero = np.zeros(W * W, np.float32)
    ub, vb = ref_camera.ndc_base(W, W, 1, jnp.asarray(px), jnp.asarray(py), jnp.asarray(zero),
                                 jnp.asarray(zero))

    def ref_dirs():
        _, d = ref_camera.camera_ray(ref_r.camera_params(cam), W, W, 1,
                                     ref_key(jnp.uint32(7), jnp.uint32(0)),
                                     jnp.asarray(sid, jnp.uint32), None, None, None, None,
                                     poly_trig=True, has_dof=False, uv_base=(ub, vb))
        return np.stack([np.asarray(c) for c in d], 1)

    ub_p, vb_p = camera.ndc_base(W, W, 1, torch.from_numpy(px), torch.from_numpy(py),
                                 torch.from_numpy(zero), torch.from_numpy(zero))
    _, d = camera.camera_ray(port_r.camera_params(cam), W, W, 1, render_key(7, 0),
                             torch.from_numpy(sid), (ub_p, vb_p), poly_trig=True, has_dof=False)
    port = np.stack([c.numpy() for c in d], 1)
    with jax.disable_jit():
        rsqrt = ref_dirs()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref_v3, "jax_rsqrt", lambda v: 1.0 / jnp.sqrt(v))
            one_over_sqrt = ref_dirs()
    np.testing.assert_array_equal(port, one_over_sqrt)
    n_rsqrt = int((port != rsqrt).any(axis=1).sum())
    print(f"prim_grid(24) camera directions differing from the reference's rsqrt: "
          f"{n_rsqrt} of {W * W}")
    assert n_rsqrt > 0


def test_prim_grid_24_bit_equal_to_the_reference_with_one_over_sqrt():
    """The tight budget: every lane and channel bit for bit, equal rays,
    against the reference run eagerly with 1/sqrt (16x16, spp 2,
    max_bounces 4, seed 7)."""
    ref, port, _ = _traced("prim_grid:24", 16, 2, 4, 7, eager=True)
    res = _lanes_off(ref, port)
    print(f"prim_grid(24) vs the eager 1/sqrt reference: {res}")
    assert all(neq == 0 for _, neq, _ in res.values()), res
    assert int(port.rays) == int(ref.rays) > 0


def test_prim_grid_24_within_budget_of_the_reference_as_it_runs():
    """Against the jitted reference (its looped sweeps forced on, which it
    proves bit-equal to the unrolled ones, to keep the compile short) at
    32x32: at most 1/32 of the lanes off per channel, image means within
    5e-3, rays within 0.1 %."""
    W = 32
    ref, port, _ = _traced("prim_grid:24", W, 2, 4, 7, force_looped=True)
    res = _lanes_off(ref, port)
    print(f"prim_grid(24) 32x32 vs the jitted reference (lanes off, not bit-equal, "
          f"mean diff): {res}; rays {int(port.rays)} vs {int(ref.rays)}")
    for f, (off, _, mean) in res.items():
        assert off <= W * W // 32 and mean < 5e-3, (f, off, mean)
    assert abs(int(port.rays) - int(ref.rays)) <= 1e-3 * int(ref.rays)


# --- the looped sweeps, per lane ------------------------------------------------

# (scene, spp, max_bounces, seed, force the reference's looped sweeps,
#  lanes off allowed per channel of 256, rays' relative difference allowed)
SWEEP_CASES = [
    # light_field(12) is under the reference's light threshold: forced looped
    ("light_field:12", 2, 3, 5, True, 0, 0.0),
    # 258 spheres in media: knife-edge scatters, the volume budget
    ("cloud_field", 2, 4, 11, False, 2, 5e-3),
    # 202 primitives: grazing hits, prim_grid(24)'s budget
    ("prim_grid:200", 2, 4, 7, False, 8, 1e-3),
]


@pytest.mark.parametrize("case", SWEEP_CASES, ids=[c[0] for c in SWEEP_CASES])
def test_looped_sweep_trace_core_matches_xla_per_lane(case):
    """trace_core against the XLA trace on the reference's looped sweeps
    (16x16, NORMAL: radiance, albedo and normal AOVs). Measured: 0 lanes
    off and equal rays on light_field(12); cloud_field 1 lane of radiance,
    rays 8,177 against 8,190; prim_grid(200) 7 lanes of radiance and 27 of
    the normal AOV, equal rays. The normal AOV of prim_grid is held at
    1/8: its grazing sphere hits amplify the ulps most."""
    name, spp, mb, seed, force, allowed, rays_rel = case
    ref, port, cfg = _traced(name, 16, spp, mb, seed, force_looped=force)
    assert cfg.looped_sweep or name.startswith("light_field")
    res = _lanes_off(ref, port)
    print(f"{name} vs the jitted reference (lanes off, not bit-equal, mean diff): {res}; "
          f"rays {int(port.rays)} vs {int(ref.rays)}")
    for f, (off, _, mean) in res.items():
        budget = 32 if (f == "aov_normal" and name.startswith("prim_grid")) else allowed
        assert off <= budget and mean < 5e-3, (f, off, mean)
    assert abs(int(port.rays) - int(ref.rays)) <= rays_rel * int(ref.rays)
    assert float(np.asarray(ref.radiance.x).sum()) > 0.0


LOOPED_SCENES = {
    "build_prim_grid(256)": lambda: bendy_tpu_torch.build_prim_grid(256),
    "build_light_field(200)": lambda: bendy_tpu_torch.build_light_field(200),
    "cloud_field": lambda: load_scene("scenes/cloud_field.json.gz"),
}


@pytest.mark.parametrize("name", list(LOOPED_SCENES))
def test_renderer_renders_the_looped_scenes_on_the_cpu(name):
    """Renderer(device="cpu") renders the scenes past the loop thresholds
    (258 and 201 primitives, 200 lights, 256 volume puffs) instead of
    raising, chunked or not to the same film."""
    scene = LOOPED_SCENES[name]()
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = 1.0
    r = Renderer(scene, Config(max_bounces=3), device="cpu")
    cfg = r.trace_config(r.config, cam)
    assert cfg.looped_sweep and (cfg.looped_lights or "light" not in name)
    films = []
    for max_lanes in (1 << 21, 8 * 3):
        film = Film(8, 8)
        Renderer(scene, Config(max_bounces=3), max_lanes=max_lanes, device="cpu").render(
            cam, RenderConfig(samples=1, subsample=Subsample(1)), film, seed=2)
        films.append(film)
    np.testing.assert_array_equal(films[0].sum, films[1].sum)
    assert np.isfinite(films[0].mean()).all() and films[0].mean().mean() > 0.0


@pytest.mark.parametrize("name", ["prim_grid", "prim_grid_diffuse", "light_field",
                                  "cuboid_light", "cloud_field"])
def test_model_builders_dump_byte_equal(name):
    """The copied builders build what the reference's do, byte for byte."""
    ours, theirs = {
        "prim_grid": (lambda: bendy_tpu_torch.build_prim_grid(48),
                      lambda: ref_build_prim_grid(48)),
        "prim_grid_diffuse": (lambda: bendy_tpu_torch.build_prim_grid(24, mix="diffuse"),
                              lambda: ref_build_prim_grid(24, mix="diffuse")),
        "light_field": (lambda: bendy_tpu_torch.build_light_field(30),
                        lambda: ref_build_light_field(30)),
        "cuboid_light": (bendy_tpu_torch.build_cuboid_light, ref_build_cuboid_light),
        "cloud_field": (bendy_tpu_torch.build_cloud_field, ref_build_cloud_field),
    }[name]
    assert dumps_scene(ours()) == ref_scene.dumps_scene(theirs())
