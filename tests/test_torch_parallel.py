"""Port parity for the sharded pass (bendy_tpu_torch/parallel).

Gloo ranks spawned on the CPU render one pass of a (tiles, samples) mesh;
the film must equal the port's single-device ``render_pass`` within rtol
2e-5 / atol 2e-5 (the tolerance of tests/test_parallel.py: only the f32
summation order of the samples axis differs) with equal int64 ray counts,
at 16x16, 4 spp, seed 3. The 2x2 cornell film is also held to the
reference's ``bendy_tpu.parallel.mesh.render_pass_sharded`` on
``make_mesh(2, 2)`` (conftest's virtual CPU devices, in process) within
the per-lane tolerance the port holds against the reference (rtol 5e-4,
atol 1e-5). The ranks run ``make_kernel_pass_sharded``, whose tracer is
the plain integrator on CPU lanes; its CUDA launch needs a card, and
chip_smoke.py holds it there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bendy_tpu.parallel.mesh import make_mesh as ref_make_mesh
from bendy_tpu.parallel.mesh import render_pass_sharded as ref_render_pass_sharded
from bendy_tpu.render import Config as RefConfig
from bendy_tpu.render import Renderer as RefRenderer
from bendy_tpu.scene import load_scene as ref_load
from bendy_tpu_torch import Config, Renderer, load_scene
from bendy_tpu_torch.parallel import choose_backend, spawn
from bendy_tpu_torch.parallel.mesh import render_scene_pass
from bendy_tpu_torch.render import render_pass
from torch_threads import one_intra_op_thread  # noqa: F401

W = H = 16
SPP = 4
SEED = 3
CONFIGS = {
    "cornell": Config(max_bounces=2),
    "blackhole_cloud": Config(max_bounces=2, volume_step=0.6),
    "dense_cloud": Config(max_bounces=2),
}
MESHES = [("cornell", 2, 2), ("cornell", 2, 1), ("cornell", 1, 2),
          ("blackhole_cloud", 2, 2), ("dense_cloud", 2, 2)]


def _scene(name, lib=load_scene):
    scene = lib(f"scenes/{name}.json.gz")
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = W / H
    return scene, cam


def _single(name):
    scene, cam = _scene(name)
    r = Renderer(scene, CONFIGS[name], device="cpu")
    return render_pass(r.arrays, r.camera_params(cam), SEED, 0, 0, W, H, H, SPP, 1,
                       r.trace_config(r.config, cam), "full")


_FILMS = {}


def _sharded(name, tiles, samples, tmp_path_factory):
    """(sums [H, W, 3], int64 rays) of one pass spawned on a gloo mesh,
    once per module."""
    key = (name, tiles, samples)
    if key not in _FILMS:
        out = str(tmp_path_factory.mktemp("mesh") / "pass.npz")
        spawn(render_scene_pass, tiles, samples, device="cpu", timeout_s=240,
              args=(f"scenes/{name}.json.gz", CONFIGS[name], W, H, SPP, 1, SEED, 0, out))
        z = np.load(out)
        _FILMS[key] = z["sums"], int(z["rays"])
    return _FILMS[key]


@pytest.mark.parametrize("name,tiles,samples", MESHES,
                         ids=[f"{n}-{t}x{s}" for n, t, s in MESHES])
def test_sharded_equals_single_device(name, tiles, samples, tmp_path_factory):
    sums, rays = _sharded(name, tiles, samples, tmp_path_factory)
    single, single_rays = _single(name)
    assert sums.shape == (H, W, 3) and np.isfinite(sums).all() and sums.mean() > 0
    np.testing.assert_allclose(sums, single.numpy(), rtol=2e-5, atol=2e-5)
    assert rays == int(single_rays) and single_rays.dtype == torch.int64


def test_sharded_equals_reference_mesh(tmp_path_factory):
    sums, rays = _sharded("cornell", 2, 2, tmp_path_factory)
    scene, cam = _scene("cornell", ref_load)
    r = RefRenderer(scene, RefConfig(max_bounces=2), use_pallas=False)
    ref, ref_rays = ref_render_pass_sharded(
        r.arrays, r.camera_params(cam), jnp.uint32(SEED), jnp.uint32(0), ref_make_mesh(2, 2),
        W, H, SPP // 2, 1, r.trace_config(r.config, cam), "full")
    np.testing.assert_allclose(sums, np.asarray(ref), rtol=5e-4, atol=1e-5)
    assert rays == int(float(ref_rays))


def test_backend_rule():
    with pytest.raises(ValueError, match="gloo"):
        choose_backend("cpu", 2, "nccl")
    assert choose_backend("cpu", 4) == "gloo"
    with pytest.raises(ValueError, match="card"):  # more nccl ranks than cards
        choose_backend("cuda", torch.cuda.device_count() + 1, "nccl")
    with pytest.raises(ValueError, match="card"):  # the default on CUDA is nccl
        choose_backend("cuda", torch.cuda.device_count() + 1)
    assert choose_backend("cuda", 4, "gloo") == "gloo"  # ranks may share a card
    with pytest.raises(ValueError, match="card"):  # refused before any rank starts
        spawn(render_scene_pass, 2, 2, device="cuda", backend="nccl", timeout_s=30,
              args=("scenes/cornell.json.gz", Config(), W, H, SPP, 1, 0, 0, "x.npz"))


def test_mesh_refusals(tmp_path):
    """A failing rank fails the caller; a mesh must match the world."""
    out = str(tmp_path / "never.npz")
    with pytest.raises(Exception, match="divisible"):  # a failing rank fails the caller
        spawn(render_scene_pass, 3, 1, device="cpu", timeout_s=120,
              args=("scenes/cornell.json.gz", Config(max_bounces=1), W, H, SPP, 1, 0, 0, out))


def test_make_mesh_refusals():
    """In process, a gloo world of one: the mesh must match the world, and
    the rows must split evenly over the tiles."""
    import torch.distributed as dist

    from bendy_tpu_torch.parallel import initialize, make_mesh, render_pass_sharded
    from bendy_tpu_torch.parallel.multihost import free_port

    initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cpu", timeout_s=60)
    try:
        with pytest.raises(ValueError, match="needs 4 ranks"):
            make_mesh(2, 2, "cpu")
        mesh = make_mesh(1, 1, "cpu")
        assert (mesh.ti, mesh.si, mesh.world, mesh.device.type) == (0, 0, 1, "cpu")
        scene, cam = _scene("cornell")
        r = Renderer(scene, CONFIGS["cornell"], device="cpu")
        cfg = r.trace_config(r.config, cam)
        sums, rays = render_pass_sharded(r.arrays, r.camera_params(cam), SEED, 0, mesh, W, H,
                                         SPP, 1, cfg, "full")
        single, single_rays = _single("cornell")
        torch.testing.assert_close(sums, single, rtol=0, atol=0)  # one rank: the same sums
        assert int(rays) == int(single_rays)
    finally:
        dist.destroy_process_group()
