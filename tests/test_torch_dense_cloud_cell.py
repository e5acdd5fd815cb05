"""The benchmark's dense_cloud configuration on the port, and the tracer's
volume-event counter, on the CPU.

- The Renderer renders the configuration's own file (``benchmark/configs/
  dense_cloud.json``: upstream's media scene ``cloud.json.gz``, a 16³
  density grid in a sphere, ``Config::DEFAULT``) at 16×9 (the cell's
  aspect) and at 8×8 with 2×2 subpixels, 2 spp, and its film and rays equal
  the benchmark's frozen reference bit for bit.
- ``telemetry.counters()["vol_events"]`` counts only in profiled passes:
  0 unprofiled and after ``clear()``; in a profiled pass the reference's
  volume events over the same pixels, on this scene and on upstream's other
  media scene (``volume.json.gz``, 8³); 0 on cornell, which has no media.
  A renderer counts into one [3] int64 tally; passes and renderers add up.
- The configuration's ``reduced`` is its ``BENCHMARK.json`` entry's, and its
  scene file is ``scenes/cloud.json.gz`` byte for byte.
- On a card (``-m card``): the kernel route's counter equals the plain
  route's, and the film is within the port's per-lane tolerance.
"""

import contextlib
import functools
import json
from pathlib import Path

import pytest
import torch

from benchmark import spec
from benchmark.check import ATOL, RTOL
from benchmark.reference import integrate, scene_io
from bendy_tpu_torch import telemetry
from bendy_tpu_torch.film import DeviceFilm
from bendy_tpu_torch.render import Config, Output, Renderer, RenderConfig, Subsample
from bendy_tpu_torch.scene import load_scene
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "benchmark/configs/dense_cloud.json").read_text())
SCENE = str(ROOT / CONFIG["scene"])
VOLUME = str(ROOT / "scenes/volume.json.gz")  # upstream's other media scene, an 8³ grid
SPP, SEED = 2, 2**31 + 43
CPU = [torch.profiler.ProfilerActivity.CPU]
NO_EVENTS = {"loop_thread_iters": 0, "loop_issued_iters": 0, "vol_events": 0}


def _renderer(scene_path, render, width, height, device="cpu"):
    scene = load_scene(scene_path)
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = width / height
    knobs = {k: v for k, v in render.items() if k != "output"}
    return Renderer(scene, Config(output=Output(render["output"]), **knobs), device=device), cam


def port_pass(scene_path, render, width, height, n, spp=SPP, profiled=True, device="cpu"):
    """(film sums [W·H, 3], rays, counters) of one pass from a clear record."""
    r, cam = _renderer(scene_path, render, width, height, device)
    film = DeviceFilm(width, height, device=device)
    telemetry.clear()
    with torch.profiler.profile(activities=CPU) if profiled else contextlib.nullcontext():
        r.render(cam, RenderConfig(samples=spp, subsample=Subsample(n)), film, seed=SEED)
    return film.sum.reshape(-1, 3).cpu().clone(), r.rays_traced, telemetry.counters()


@functools.cache
def cloud_pass(width, height, n):
    return port_pass(SCENE, CONFIG["render"], width, height, n)


@functools.cache
def reference(width, height, n, scene_path=SCENE):
    """(sums [W·H, 3], counts) of the frozen reference's pass 0."""
    scene = scene_io.load_scene(scene_path)
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = width / height
    arrays = integrate.scene_arrays(scene, "cpu")
    knobs = {k: v for k, v in CONFIG["render"].items() if k != "output"}
    cfg = integrate.trace_config(scene, arrays, cam, **knobs)
    assert cfg.has_volumes
    return integrate.pass_sums(arrays, integrate.camera_params(scene, cam, "cpu"), cfg, SEED, 0,
                               torch.arange(width * height), width, height, SPP, n)


def reference_match(width, height, n):
    film, rays, _ = cloud_pass(width, height, n)
    sums, counts = reference(width, height, n)
    assert torch.equal(film, sums.float())
    assert rays == counts["rays"] > 0


def profiled_render(r, cam, seed, width=8, height=6):
    with torch.profiler.profile(activities=CPU):
        r.render(cam, RenderConfig(samples=1, subsample=Subsample(1)),
                 DeviceFilm(width, height, device="cpu"), seed=seed)


def counts_only_while_profiled():
    telemetry.clear()
    film, rays, counted = port_pass(SCENE, CONFIG["render"], 8, 6, 1, profiled=False)
    assert counted == NO_EVENTS and rays > 0
    r, cam = _renderer(SCENE, CONFIG["render"], 8, 6)
    profiled_render(r, cam, SEED)
    assert telemetry.counters()["vol_events"] == r._counts[2].item() > 0
    telemetry.clear()  # forgets the tallies and zeroes them
    assert telemetry.counters() == NO_EVENTS and r._counts.tolist() == [0, 0, 0]


def counts_the_references_events(width, height, n, scene_path=SCENE):
    _, _, counted = port_pass(scene_path, CONFIG["render"], width, height, n)
    _, counts = reference(width, height, n, scene_path)
    assert counted["vol_events"] == counts["vol_events"] > 0


def media_do_most_of_it():
    """Most of the cell's traced segments are volume events."""
    _, counts = reference(16, 9, 1)
    assert counts["vol_events"] > 0.5 * counts["rays"]


def none_without_media():
    _, rays, counted = port_pass("scenes/cornell.json.gz", {"max_bounces": 8, "output": "full"},
                                 8, 8, 1)
    assert counted["vol_events"] == 0 < rays and counted["loop_thread_iters"] > 0


def one_tally_a_renderer():
    """The renderer's tally is one [3] int64 word triple, read in the order
    of ``telemetry.COUNTERS``; an unprofiled pass after it adds nothing."""
    telemetry.clear()
    r, cam = _renderer(SCENE, CONFIG["render"], 8, 6)
    profiled_render(r, cam, SEED)
    assert r._counts.dtype == torch.int64 and r._counts.shape == (3,)
    counted = telemetry.counters()
    assert counted == dict(zip(telemetry.COUNTERS, r._counts.tolist()))
    r.render(cam, RenderConfig(samples=1, subsample=Subsample(1)),
             DeviceFilm(8, 6, device="cpu"), seed=SEED + 1)
    assert telemetry.counters() == counted


def passes_add_up():
    """Two profiled passes count what each counts alone."""
    alone = []
    for seed in (SEED, SEED + 1):
        telemetry.clear()
        r, cam = _renderer(SCENE, CONFIG["render"], 8, 6)
        profiled_render(r, cam, seed)
        alone.append(telemetry.counters())
    telemetry.clear()
    r, cam = _renderer(SCENE, CONFIG["render"], 8, 6)
    profiled_render(r, cam, SEED)
    profiled_render(r, cam, SEED + 1)
    assert telemetry.counters() == {k: alone[0][k] + alone[1][k] for k in telemetry.COUNTERS}


def renderers_add_up():
    """Two renderers' tallies are summed: the cloud's events and cornell's none."""
    telemetry.clear()
    r, cam = _renderer(SCENE, CONFIG["render"], 8, 6)
    profiled_render(r, cam, SEED)
    cloud = r._counts.tolist()
    c, ccam = _renderer("scenes/cornell.json.gz", {"max_bounces": 8, "output": "full"}, 8, 6)
    profiled_render(c, ccam, SEED)
    box = c._counts.tolist()
    assert box[2] == 0 < cloud[2]
    assert telemetry.counters() == dict(zip(telemetry.COUNTERS, map(sum, zip(cloud, box))))


def config_matches_its_entry():
    conf = {c["name"]: c for c in spec.load_benchmark()["configs"]}["dense_cloud"]
    assert conf["file"] == "benchmark/configs/dense_cloud.json"
    assert sorted(conf["reduced"]) == sorted(CONFIG["reduced"]) == []
    assert CONFIG["precision"] == "float32" and CONFIG["render"]["max_bounces"] == 8


def scene_is_the_bundled_one():
    assert Path(SCENE).read_bytes() == (ROOT / "scenes/cloud.json.gz").read_bytes()


CASES = {
    "reference-16x9": functools.partial(reference_match, 16, 9, 1),
    "reference-8x8-2x2": functools.partial(reference_match, 8, 8, 2),
    "counts-only-while-profiled": counts_only_while_profiled,
    "counts-the-references-events": functools.partial(counts_the_references_events, 16, 9, 1),
    "counts-the-references-events-8x8-2x2":
        functools.partial(counts_the_references_events, 8, 8, 2),
    "counts-the-references-events-on-volume":
        functools.partial(counts_the_references_events, 8, 6, 1, VOLUME),
    "media-do-most-of-it": media_do_most_of_it,
    "no-events-without-media": none_without_media,
    "one-tally-a-renderer": one_tally_a_renderer,
    "passes-add-up": passes_add_up,
    "renderers-add-up": renderers_add_up,
    "config-matches-its-entry": config_matches_its_entry,
    "scene-is-the-bundled-one": scene_is_the_bundled_one,
}


@pytest.mark.parametrize("case", list(CASES))
def test_dense_cloud_cell(case):
    CASES[case]()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tracer kernel runs only there")
    return torch.device("cuda")


@pytest.mark.card
def test_the_kernels_volume_events_are_the_plain_routes(card):
    """At 64×36 and 16 spp the volume item kernel's counter equals the plain
    integrator's sum over the same lanes, and the film is within the port's
    per-lane tolerance of the plain one."""
    got, rays, counted = port_pass(SCENE, CONFIG["render"], 64, 36, 1, spp=16, device=card)
    want, want_rays, plain = port_pass(SCENE, CONFIG["render"], 64, 36, 1, spp=16)
    assert counted["vol_events"] == plain["vol_events"] > 0
    assert rays == want_rays
    assert ((got - want).abs() <= ATOL + RTOL * want.abs()).all()
