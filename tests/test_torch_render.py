"""Port parity: the Renderer front end, films and package hygiene (CPU)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import bendy_tpu.film as ref_film
from bendy_tpu_torch import Config, DeviceFilm, Film, Output, RenderConfig, Renderer, Status, Subsample
from bendy_tpu_torch import load_scene


def _cornell():
    scene = load_scene("scenes/cornell.json.gz")
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = 1.0
    return scene, cam


def test_cornell_golden():
    """The reference's CPU golden (tests/golden/README), held at its own
    rtol 1e-5 — the port renders the same image, not just the same
    statistics (the RNG words are identical)."""
    scene, cam = _cornell()
    r = Renderer(scene, Config(max_bounces=3), device="cpu")
    film = Film(16, 16)
    assert r.render(cam, RenderConfig(samples=8, subsample=Subsample(1)), film, seed=7) \
        is Status.IN_PROGRESS
    golden = np.load("tests/golden/cornell_16x16_mb3_s8_seed7.npy")
    np.testing.assert_allclose(film.mean(), golden, rtol=1e-5, atol=1e-6)
    assert film.samples == 8 and film.passes == 1
    assert isinstance(r.rays_traced, int) and r.rays_traced > 16 * 16 * 8


def test_zero_samples_is_done():
    scene, cam = _cornell()
    film = Film(8, 8)
    assert Renderer(scene, device="cpu").render(cam, RenderConfig(samples=0), film) \
        is Status.DONE
    assert film.passes == 0


def test_row_chunking_changes_no_pixel():
    scene, cam = _cornell()
    rc = RenderConfig(samples=2, subsample=Subsample(2))
    whole, chunked = Film(12, 10), Film(12, 10)
    r1 = Renderer(scene, Config(max_bounces=2), device="cpu")
    r1.render(cam, rc, whole, seed=3)
    r2 = Renderer(scene, Config(max_bounces=2), max_lanes=12 * 4 * 3,  # 3-row chunks
                  device="cpu")
    r2.render(cam, rc, chunked, seed=3)
    np.testing.assert_array_equal(chunked.sum, whole.sum)
    assert r2.rays_traced == r1.rays_traced


def test_device_film_matches_host_film_and_aov_outputs():
    scene, cam = _cornell()
    r = Renderer(scene, Config(max_bounces=2), device="cpu")
    host, dev = Film(8, 8), DeviceFilm(8, 8, device="cpu")
    for film in (host, dev):
        for _ in range(2):
            r.render(cam, RenderConfig(samples=1), film, seed=5)
    assert isinstance(dev.sum, torch.Tensor)
    np.testing.assert_array_equal(dev.mean(), host.mean())
    depth = Film(8, 8)
    r.render(cam, RenderConfig(samples=2, output=Output.DEPTH), depth, seed=5)
    assert np.all((depth.mean() >= 0.0) & (depth.mean() <= 1.0))


def test_checkpoints_cross_load(tmp_path):
    scene, cam = _cornell()
    film = DeviceFilm(8, 8, device="cpu")
    Renderer(scene, Config(max_bounces=2), device="cpu").render(
        cam, RenderConfig(samples=2), film, seed=9)
    ours = str(tmp_path / "port.npz")
    film.save_checkpoint(ours, seed=9)
    back, seed = ref_film.Film.load_checkpoint(ours)
    assert seed == 9 and back.samples == 2 and back.passes == 1
    np.testing.assert_array_equal(back.sum, film.sum.numpy())
    theirs = str(tmp_path / "ref.npz")
    back.save_checkpoint(theirs, seed=9)
    again, seed = Film.load_checkpoint(theirs)
    assert seed == 9 and (again.samples, again.passes) == (2, 1)
    np.testing.assert_array_equal(again.sum, film.sum.numpy())
    on_dev = DeviceFilm.from_film(again, device="cpu")
    np.testing.assert_array_equal(on_dev.mean(), again.mean())


def test_import_leaves_jax_out():
    code = ("import sys, bendy_tpu_torch, bendy_tpu_torch.parallel, bendy_tpu_torch.cli, "
            "bendy_tpu_torch.preview, bendy_tpu_torch.tools.vpu_peak, "
            "bendy_tpu_torch.tools.mxu_shape_probe, bendy_tpu_torch.tools.checkout_ab, "
            "bendy_tpu_torch.bench, bendy_tpu_torch.native, bendy_tpu_torch.tools.fidelity; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'bendy_tpu.'))"
            " or m == 'bendy_tpu']; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the card-less refusal")
    scene, _ = _cornell()
    with pytest.raises(RuntimeError, match="cuda"):
        Renderer(scene, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceFilm(8, 8, device="cuda")
