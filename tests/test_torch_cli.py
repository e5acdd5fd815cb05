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


def test_cli_profile_holds_program_spans(tmp_path):
    """--profile writes the program's spans into its trace on the trace's
    clock: one bendy.render a pass, each holding its bendy.glue.* events."""
    prof = tmp_path / "prof"
    assert main(_args(tmp_path, **{"--profile": str(prof), "--samples": "6"})) == 0
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "bendy"]
    renders = sorted((e for e in ours if e["name"] == "bendy.render"), key=lambda e: e["ts"])
    assert [e["args"]["pass"] for e in renders] == [0, 1, 2]
    clock = next(e for e in events if e.get("name") == "bendy.clock")
    assert clock["ts"] <= renders[0]["ts"]
    for r in renders:
        glue = [e for e in ours if e["args"]["parent"] == r["args"]["span"]
                and e["name"].startswith("bendy.glue.")]
        assert sorted(e["name"] for e in glue) == ["bendy.glue.accumulate", "bendy.glue.trace"]
        for g in glue:
            assert r["ts"] <= g["ts"] and g["ts"] + g["dur"] <= r["ts"] + r["dur"] + 1e-3
            assert (g["pid"], g["tid"]) == (r["pid"], r["tid"]) == (clock["pid"], clock["tid"])


def test_stats_rate_is_over_wall_time(monkeypatch):
    """/stats' mrays: the rays so far over the wall time since the render
    started, not over the summed host enqueue times."""
    from bendy_tpu_torch import cli

    class Traced:
        rays_traced = 6_000_000

    monkeypatch.setattr(cli.time, "time", lambda: 104.0)
    assert cli.wall_mrays(Traced(), 100.0) == {"mrays": 1.5}


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


# ---------------------------------------------------------------------------
# The live loop's control commands and the preview server, held to the
# reference's (tests/test_preview.py:35-92, 113-210) on the same arguments.

COMMANDS = [
    ("reload-scene", {}),
    ("resize", {"width": "16", "height": "8"}),
    ("checkpoint", {"path": "film.npz"}),
    ("camera", {"x": "1.5", "y": "2.0"}),
    ("camera", {"x": "0", "y": "0", "z": "5", "tx": "0", "ty": "0", "tz": "0"}),
    ("save-scene", {"path": "saved.json.gz"}),
    ("save-scene", {}),
    ("screenshot", {}),
    ("stop", {}),
    ("format-disk", {}),  # unknown: nothing changes
]


def _side(tmp_path, port: bool):
    """(handle_command, scene, renderer, camera, film, args, dumps) of one
    CLI: the port's on the CPU, or the reference's; the cornell scene saved
    to its own file, an 8x8 film holding one pass."""
    import argparse

    if port:
        from bendy_tpu_torch.cli import handle_command
        from bendy_tpu_torch.render import Config, Renderer
        from bendy_tpu_torch.scene.io import dumps_scene, load_scene, save_scene
    else:
        from bendy_tpu.cli import handle_command
        from bendy_tpu.film import Film as RefFilm
        from bendy_tpu.render import Config, Renderer
        from bendy_tpu.scene import dumps_scene, load_scene, save_scene
    d = tmp_path / ("port" if port else "ref")
    d.mkdir()
    scene = load_scene("scenes/cornell.json.gz")
    camera = scene.find_by_tag("camera")
    scene.get_object(camera).as_camera().aspect_ratio = 1.0
    renderer = (Renderer(scene, Config(max_bounces=1), device="cpu") if port
                else Renderer(scene, Config(max_bounces=1), use_pallas=False))
    film = Film(8, 8) if port else RefFilm(8, 8)
    film.add_pass(np.random.default_rng(0).random((8, 8, 3)).astype(np.float32), 1)
    scene_path = str(d / "scene.json.gz")
    save_scene(scene_path, scene)
    args = argparse.Namespace(scene=scene_path, screenshot=str(d / "shot.png"),
                              save_scene=None, checkpoint=None, seed=4)
    return handle_command, scene, renderer, camera, film, args, dumps_scene, d


@pytest.mark.parametrize("name,cargs", COMMANDS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(COMMANDS)])
def test_command_handler_matches_reference(tmp_path, monkeypatch, name, cargs):
    """Each control command through the port's handle_command leaves the
    scene, renderer, camera, film and written files as the reference's
    handler does on the same arguments (relative paths land in each side's
    own directory)."""
    import gzip

    sides = []
    for handle, scene, renderer, camera, film, args, dumps, d in [_side(tmp_path, port)
                                                                  for port in (True, False)]:
        monkeypatch.chdir(d)
        s2, r2, cam2, stopped = handle(name, dict(cargs), args, scene, renderer, camera, film)
        sides.append(dict(scene=s2, renderer=r2, camera=cam2, stopped=stopped, film=film,
                          dumps=dumps(s2), d=d, replaced=(s2 is not scene, r2 is not renderer),
                          world=np.array(s2.get_object(cam2).transform.world),
                          aspect=s2.get_object(cam2).as_camera().aspect_ratio))
    ours, ref = sides
    assert ours["stopped"] == ref["stopped"] == (name == "stop")
    assert ours["replaced"] == ref["replaced"] == ((True, True) if name == "reload-scene"
                                                   else (False, False))
    if name == "reload-scene":
        assert ours["renderer"].device == torch.device("cpu")
    assert ours["dumps"] == ref["dumps"]
    assert np.array_equal(ours["world"], ref["world"]) and ours["aspect"] == ref["aspect"]
    f, g = ours["film"], ref["film"]
    assert (f.width, f.height, f.samples, f.passes) == (g.width, g.height, g.samples, g.passes)
    assert np.array_equal(np.asarray(f.sum), np.asarray(g.sum))
    files = sorted(p.name for p in ours["d"].iterdir())
    assert files == sorted(p.name for p in ref["d"].iterdir())
    for fname in files:
        a, b = ours["d"] / fname, ref["d"] / fname
        if fname.endswith(".npz"):
            (fa, sa), (fb, sb) = Film.load_checkpoint(str(a)), Film.load_checkpoint(str(b))
            assert sa == sb == 4 and np.array_equal(fa.sum, fb.sum)
            assert (fa.samples, fa.passes) == (fb.samples, fb.passes) == (1, 1)
        elif fname.endswith(".png"):
            assert np.array_equal(_png(a), _png(b))
        else:
            assert gzip.decompress(a.read_bytes()) == gzip.decompress(b.read_bytes())


def _post(port, path):
    req = urllib.request.Request(f"http://localhost:{port}{path}", method="POST")
    return json.load(urllib.request.urlopen(req, timeout=10))


def test_preview_commands_match_reference():
    """The same POSTs queue the same commands on both servers; an unknown
    command is a 404 and a path leaving the working directory a 400 on both,
    and neither queues anything."""
    import urllib.error

    from bendy_tpu.preview import PreviewServer as RefServer
    from bendy_tpu_torch.preview import PreviewServer

    posts = ["/screenshot", "/reload-scene", "/resize?width=32&height=16",
             "/camera?x=1&tx=0", "/checkpoint?path=a.npz", "/save-scene", "/stop"]
    drained = []
    for cls in (PreviewServer, RefServer):
        srv = cls(0)
        try:
            assert [_post(srv.port, p) for p in posts] == [{"queued": True}] * len(posts)
            codes = []
            for bad in ("/format-disk", "/checkpoint?path=../x.npz", "/save-scene?path=/etc/x"):
                with pytest.raises(urllib.error.HTTPError) as e:
                    _post(srv.port, bad)
                codes.append(e.value.code)
            drained.append((srv.drain_commands(), codes, srv.drain_commands()))
        finally:
            srv.close()
    assert drained[0] == drained[1]
    cmds, codes, again = drained[0]
    assert [c[0] for c in cmds] == [p[1:].split("?")[0] for p in posts]
    assert cmds[2][1] == {"width": "32", "height": "16"} and codes == [404, 400, 400]
    assert again == []


def test_preview_fetches_frame_and_stats_only_on_demand():
    """As the reference's server: the film is fetched and encoded on the
    first publish and then only after a /frame.png request, and the lazy
    stats run only after a /stats request, their last value kept."""
    from bendy_tpu_torch.preview import PreviewServer

    film = Film(8, 8)
    film.add_pass(np.ones((8, 8, 3), np.float32), 1)
    fetches, calls = [], []
    orig = Film.preview

    class Counting(Film):
        def preview(self):
            fetches.append(1)
            return orig(self)

    film.__class__ = Counting

    def lazy():
        calls.append(1)
        return {"mrays": float(len(calls))}

    srv = PreviewServer(0)
    try:
        srv.publish(film, lazy=lazy)
        srv.publish(film, lazy=lazy)
        assert (len(fetches), calls) == (1, [])
        png = urllib.request.urlopen(f"http://localhost:{srv.port}/frame.png", timeout=10).read()
        assert png[:4] == b"\x89PNG"
        stats = json.load(urllib.request.urlopen(f"http://localhost:{srv.port}/stats", timeout=10))
        assert stats["passes"] == 1 and "mrays" not in stats
        srv.publish(film, lazy=lazy)  # both asked for: fetch and compute
        assert (len(fetches), len(calls)) == (2, 1)
        srv.publish(film, lazy=lazy)  # consumed: idle again
        assert (len(fetches), len(calls)) == (2, 1)
        stats = json.load(urllib.request.urlopen(f"http://localhost:{srv.port}/stats", timeout=10))
        assert stats["mrays"] == 1.0
    finally:
        srv.close()
