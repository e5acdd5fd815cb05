"""The port's CLI end to end on the CPU (``--device cpu``): the reference
binary's surface (``src/main.rs:49-72``) through bendy_tpu_torch.cli.main,
as tests/test_cli.py drives bendy_tpu.cli.main, and the port's checkpoint
film held to the reference CLI's at the same flags (rtol 5e-4, atol 1e-5:
the per-lane tolerance the port holds against the reference)."""

import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from bendy_tpu_torch.cli import main
from bendy_tpu_torch.film import DeviceFilm, Film


def _args(tmp_path, **over):
    base = {
        "--width": "16", "--height": "16", "--samples": "2", "--subsample": "1",
        "--scene": "scenes/cornell.json.gz",
        "--screenshot": str(tmp_path / "shot.png"),
        "--max-bounces": "2", "--spp-per-pass": "2", "--seed": "3",
        "--device": "cpu",
    }
    base.update(over)
    argv = []
    for k, v in base.items():
        argv += [k, v]
    return argv


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def test_cli_renders_screenshot(tmp_path):
    assert main(_args(tmp_path)) == 0
    img = _png(tmp_path / "shot.png")
    assert img.shape == (16, 16, 3) and img.mean() > 5  # not black


def test_cli_checkpoint_resume(tmp_path):
    ckpt = str(tmp_path / "film.npz")
    assert main(_args(tmp_path, **{"--checkpoint": ckpt})) == 0
    film, seed = Film.load_checkpoint(ckpt)
    assert film.samples == 2 and seed == 3
    # resume: max samples 4 -> one more pass on top of the checkpoint
    assert main(_args(tmp_path, **{"--checkpoint": ckpt, "--samples": "4"})) == 0
    film2, _ = Film.load_checkpoint(ckpt)
    assert film2.samples == 4 and film2.passes == 2


def test_cli_checkpoint_cadence(tmp_path, monkeypatch):
    """One save at exit by default; --checkpoint-every N saves every N
    passes plus the final one."""
    saves = []
    orig = DeviceFilm.save_checkpoint

    def counting_save(self, path, seed=0):
        saves.append(self.passes)
        return orig(self, path, seed=seed)

    monkeypatch.setattr(DeviceFilm, "save_checkpoint", counting_save)
    ckpt = str(tmp_path / "film.npz")
    assert main(_args(tmp_path, **{"--checkpoint": ckpt, "--samples": "6"})) == 0
    assert saves == [3]
    saves.clear()
    assert main(_args(tmp_path, **{"--checkpoint": ckpt, "--samples": "12",
                                   "--checkpoint-every": "2"})) == 0
    assert saves == [4, 6, 6]
    film, _ = Film.load_checkpoint(ckpt)
    assert film.samples == 12 and film.passes == 6


def test_cli_depth_channel_and_missing_camera(tmp_path):
    assert main(_args(tmp_path, **{"--output": "depth"})) == 0
    from bendy_tpu_torch.scene.io import load_scene, save_scene

    scene = load_scene("scenes/cornell.json.gz")
    scene.get_object(scene.find_by_tag("camera")).tag = "not-a-camera"
    bad = str(tmp_path / "bad.json.gz")
    save_scene(bad, scene)
    assert main(_args(tmp_path, **{"--scene": bad})) == 2


def test_cli_mesh_oneshot(tmp_path, capfd):
    assert main(_args(tmp_path, **{"--mesh": "2x2", "--samples": "4"})) == 0
    assert _png(tmp_path / "shot.png").mean() > 5
    assert "mesh 2x2: 4 spp in" in capfd.readouterr().err


def test_cli_serve_control_loop(tmp_path):
    """--serve: screenshot and stop a running render over the control API."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    rc = {}
    t = threading.Thread(target=lambda: rc.update(
        rc=main(_args(tmp_path, **{"--samples": "4096", "--serve": str(port)}))))
    t.start()
    deadline = time.time() + 120
    stats = None
    while time.time() < deadline:
        try:
            stats = json.load(urllib.request.urlopen(f"http://localhost:{port}/stats",
                                                     timeout=5))
            if stats.get("passes", 0) >= 1:
                break
        except Exception:
            time.sleep(0.2)
    assert stats is not None, "preview server never came up"
    page = urllib.request.urlopen(f"http://localhost:{port}/", timeout=5).read()
    assert b"live preview" in page
    for cmd in ("screenshot", "stop"):
        urllib.request.urlopen(urllib.request.Request(
            f"http://localhost:{port}/{cmd}", method="POST"), timeout=5)
    t.join(timeout=180)
    assert not t.is_alive(), "render loop did not stop"
    assert rc["rc"] == 0
    assert (tmp_path / "shot.png").exists()


def test_cli_turntable(tmp_path):
    assert main(_args(tmp_path, **{"--turntable": "2", "--width": "8", "--height": "8",
                                   "--samples": "1", "--scene": "scenes/scene.json.gz"})) == 0
    for i in range(2):
        assert _png(tmp_path / f"shot_{i:03d}.png").mean() > 1


def test_cli_profile(tmp_path):
    prof = tmp_path / "prof"
    assert main(_args(tmp_path, **{"--profile": str(prof)})) == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


def test_cli_debug_nans_names_the_pass(tmp_path, monkeypatch):
    from bendy_tpu_torch import render

    orig = render.Renderer.render

    def nan_render(self, camera_ref, rc, film, seed=0):
        out = orig(self, camera_ref, rc, film, seed)
        if film.passes == 2:
            film.sum[0, 0, 0] = float("nan")
        return out

    monkeypatch.setattr(render.Renderer, "render", nan_render)
    assert main(_args(tmp_path, **{"--samples": "6"})) == 0  # no check without the flag
    with pytest.raises(FloatingPointError, match="pass 1"):
        main(_args(tmp_path, **{"--samples": "6"}) + ["--debug-nans"])


def test_cli_checkpoint_matches_reference_cli(tmp_path):
    from bendy_tpu.cli import main as ref_main

    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    flags = {"--samples": "4", "--output": "normal"}
    assert main(_args(tmp_path, **flags, **{"--checkpoint": ours})) == 0
    ref_argv = _args(tmp_path, **flags, **{"--checkpoint": theirs})
    ref_argv = ref_argv[:ref_argv.index("--device")] + ref_argv[ref_argv.index("--device") + 2:]
    assert ref_main(ref_argv + ["--compile-cache", ""]) == 0
    a, seed_a = Film.load_checkpoint(ours)
    b, seed_b = Film.load_checkpoint(theirs)
    assert (a.samples, a.passes, seed_a) == (b.samples, b.passes, seed_b) == (4, 2, 3)
    np.testing.assert_allclose(a.sum, b.sum, rtol=5e-4, atol=1e-5)


def test_cli_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the card-less refusal")
    argv = _args(tmp_path)
    argv = argv[:argv.index("--device")] + argv[argv.index("--device") + 2:]
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv + ["--mesh", "1x1"])
