"""Port parity: counter-based RNG words and camera rays.

The RNG is counter-based and platform-free, so the port is held to the
reference's exact words; that is what lets the later parity tests compare
images lane by lane instead of by statistics. Inputs come from a seeded
numpy generator and include words >= 2^31 (the sign bit of int32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bendy_tpu.ops import camera as ref_camera
from bendy_tpu.render import Renderer as RefRenderer
from bendy_tpu.scene import load_scene as ref_load
from bendy_tpu.utils import rng as ref_rng
from bendy_tpu_torch import Renderer, load_scene
from bendy_tpu_torch.ops import camera
from bendy_tpu_torch.utils import rng
from torch_threads import one_intra_op_thread  # noqa: F401

N = 4096


@pytest.fixture(scope="module")
def words():
    g = np.random.default_rng(1234)
    w = g.integers(0, 2**32, size=(4, N), dtype=np.uint64).astype(np.uint32)
    w[:, :4] = [[0, 1, 2**31, 2**32 - 1]] * 4  # edges
    return w


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def test_threefry_bit_equal(words):
    ref = ref_rng.threefry2x32(*(jnp.asarray(w) for w in words))
    got = rng.threefry2x32(*(_t(w) for w in words))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(np.int64))


@pytest.mark.parametrize("seed,pass_idx", [(0, 0), (7, 0), (7, 3), (2**31 + 5, 2**32 - 1)])
def test_render_key_bit_equal(seed, pass_idx):
    ref = ref_rng.render_key(jnp.uint32(seed), jnp.uint32(pass_idx))
    assert rng.render_key(seed, pass_idx) == (int(ref[0]), int(ref[1]))


def test_pcg4d_bit_equal(words):
    ref = ref_rng.pcg4d(*(jnp.asarray(w) for w in words))
    got = rng.pcg4d(*(_t(w) for w in words))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(np.int64))


@pytest.mark.parametrize("tag,n", [("steps", 6), ("steps", 4), (rng.CAMERA_TAG, 4)])
def test_lane_uniforms_bit_equal(words, tag, n):
    key = (int(words[2, 0]) ^ 0x9E3779B9, 2**31 + 17)
    lanes = words[0]
    if tag == "steps":
        steps = (words[1] % 64).astype(np.int32)
        ref = ref_rng.lane_uniforms(key, jnp.asarray(lanes), jnp.asarray(steps), n)
        got = rng.lane_uniforms(key, _t(lanes), torch.from_numpy(steps), n)
    else:
        ref = ref_rng.lane_uniforms(key, jnp.asarray(lanes), tag, n)
        got = rng.lane_uniforms(key, _t(lanes), tag, n)
    assert len(got) == n
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("name", ["cornell", "scene"])
def test_camera_ray_matches(name):
    W, H, n = 32, 24, 2
    path = f"scenes/{name}.json.gz"
    ref_r = RefRenderer(ref_load(path), use_pallas=False)
    port_r = Renderer(load_scene(path), device="cpu")
    cam_ref = ref_r.scene.find_by_tag("camera")
    rcfg = ref_r.trace_config(ref_r.config, cam_ref)
    pcfg = port_r.trace_config(port_r.config, cam_ref)
    assert (pcfg.frustum_poly, pcfg.has_dof) == (rcfg.frustum_poly, rcfg.has_dof)

    g = np.random.default_rng(5)
    B = 1024
    px = g.integers(0, W, B).astype(np.float32)
    py = g.integers(0, H, B).astype(np.float32)
    si = g.integers(0, n, B).astype(np.float32)
    sj = g.integers(0, n, B).astype(np.float32)
    sid = g.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    key = (123456789, 2**31 + 99)
    for poly in (True, False):
        ro, rd = ref_camera.camera_ray(
            ref_r.camera_params(cam_ref), W, H, n, key, jnp.asarray(sid),
            jnp.asarray(px), jnp.asarray(py), jnp.asarray(si), jnp.asarray(sj),
            poly_trig=poly, has_dof=rcfg.has_dof,
        )
        uv = camera.ndc_base(W, H, n, *(torch.from_numpy(a) for a in (px, py, si, sj)))
        po, pd = camera.camera_ray(
            port_r.camera_params(cam_ref), W, H, n, key, _t(sid), uv,
            poly_trig=poly, has_dof=pcfg.has_dof,
        )
        for r, p in zip((*ro, *rd), (*po, *pd)):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=5e-4, atol=1e-6)
