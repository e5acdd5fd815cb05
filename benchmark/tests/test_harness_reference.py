"""The frozen reference against the port's plain integrator.

The reference traces one lane per (pixel, subpixel, sample) and folds the
samples in order; the port's plain ``trace_core`` traces one lane per
(pixel, subpixel) through its samples in sequence. Both must give the same
per-pixel sums, bit for bit, and the same ray count, on a surface scene, the
lensing scene, a medium and the looped masses."""

import pytest
import torch

from benchmark.reference import integrate, scene_io

SCENES = [  # (scene, width, height, spp, subsample, max_bounces)
    ("cornell", 16, 16, 4, 2, 8),
    ("blackhole", 16, 16, 4, 1, 2),
    ("volume", 16, 16, 2, 2, 8),
    ("mass_cluster", 8, 8, 2, 1, 2),
]


def port_pass(name, W, H, spp, n, mb, seed):
    from bendy_tpu_torch.film import DeviceFilm
    from bendy_tpu_torch.render import Config, Renderer, RenderConfig, Subsample
    from bendy_tpu_torch.scene import load_scene

    scene = load_scene(f"scenes/{name}.json.gz")
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = W / H
    r = Renderer(scene, Config(max_bounces=mb), device="cpu")
    film = DeviceFilm(W, H, device="cpu")
    r.render(cam, RenderConfig(samples=spp, subsample=Subsample(n)), film, seed=seed)
    tcfg = r.trace_config(r.config, cam)
    return film.sum.reshape(-1, 3), r.rays_traced, tcfg


def ref_pass(name, W, H, spp, n, mb, seed, pixels=None):
    scene = scene_io.load_scene(f"scenes/{name}.json.gz")
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = W / H
    arrays = integrate.scene_arrays(scene, "cpu")
    cfg = integrate.trace_config(scene, arrays, cam, max_bounces=mb)
    params = integrate.camera_params(scene, cam, "cpu")
    pix = torch.arange(W * H) if pixels is None else pixels
    sums, counts = integrate.pass_sums(arrays, params, cfg, seed, 0, pix, W, H, spp, n)
    return sums, counts, cfg


@pytest.mark.parametrize("name,W,H,spp,n,mb", SCENES)
def test_reference_equals_port_plain(name, W, H, spp, n, mb):
    seed = 2**31 + 977
    film, rays, pcfg = port_pass(name, W, H, spp, n, mb, seed)
    sums, counts, rcfg = ref_pass(name, W, H, spp, n, mb, seed)
    assert torch.equal(film, sums)
    assert rays == counts["rays"]
    for f in ("max_bounces", "frustum_poly", "has_volumes", "geodesic", "looped_masses",
              "looped_sweep", "looped_lights", "has_diffuse", "has_metallic", "has_glass",
              "has_dof", "want_aovs"):
        assert getattr(pcfg, f) == getattr(rcfg, f), f


def test_reference_any_pixel_subset():
    """Stream ids are global: a subset of pixels recomputes alone."""
    full, _, _ = ref_pass("cornell", 16, 16, 2, 2, 8, 5)
    pix = torch.tensor([3, 17, 100, 255])
    part, _, _ = ref_pass("cornell", 16, 16, 2, 2, 8, 5, pixels=pix)
    assert torch.equal(full[pix], part)


def test_reference_block_size_invariant():
    scene = scene_io.load_scene("scenes/cornell.json.gz")
    cam = scene.find_by_tag("camera")
    arrays = integrate.scene_arrays(scene, "cpu")
    cfg = integrate.trace_config(scene, arrays, cam)
    params = integrate.camera_params(scene, cam, "cpu")
    pix = torch.arange(64)
    a, ca = integrate.pass_sums(arrays, params, cfg, 9, 3, pix, 8, 8, 4, 2)
    b, cb = integrate.pass_sums(arrays, params, cfg, 9, 3, pix, 8, 8, 4, 2, block_lanes=40)
    assert torch.equal(a, b) and ca == cb

