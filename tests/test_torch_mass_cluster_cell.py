"""The benchmark's mass_cluster configuration on the port, and the tracer's
warp-use count, on the CPU.

- The Renderer renders the configuration's own file (``benchmark/configs/
  mass_cluster.json``: 64 looped masses, ``Config::DEFAULT``) at 16×12 and
  2 spp, and its film and rays match the benchmark's frozen reference to the
  port's per-lane tolerance; 2 and 8 bounces give the same film and rays,
  since every material of the scene is emissive (why the configuration cuts
  nothing).
- The one host count of the tracer's warp use (``ops/trace_kernel.warp_use``)
  on each launch's thread iterations in launch order (per-item launches,
  item = lane·s + j within each launch of s samples; cornell's lane loop,
  one thread a lane; a ragged last warp) gives, warp by warp, the
  iteration sum and 32 × the longest loop over the launch's full warps,
  and ``tools/perf_report.issued`` and ``tools.rays_per_warp_issue_slot``
  read it.
- A pass counts only while a profiler records.
"""

import functools
import json
from pathlib import Path

import pytest
import torch

from benchmark.check import ATOL, RTOL
from benchmark.reference import integrate, scene_io
from bendy_tpu_torch import telemetry
from bendy_tpu_torch.film import DeviceFilm
from bendy_tpu_torch.ops.trace_kernel import warp_use, warp_use_plain
from bendy_tpu_torch.ops.wavefront import trace_core
from bendy_tpu_torch.render import Config, Output, Renderer, RenderConfig, Subsample
from bendy_tpu_torch.scene import load_scene
from bendy_tpu_torch.tools import rays_per_warp_issue_slot
from bendy_tpu_torch.tools.perf_report import issued
from bendy_tpu_torch.utils.rng import render_key
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "benchmark/configs/mass_cluster.json").read_text())
SCENE = str(ROOT / CONFIG["scene"])
W, H, SPP, SEED = 16, 12, 2, 2**31 + 41


def _renderer(scene_path, render, width, height, device="cpu"):
    scene = load_scene(scene_path)
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = width / height
    knobs = {k: v for k, v in render.items() if k != "output"}
    return Renderer(scene, Config(output=Output(render["output"]), **knobs), device=device), cam


@functools.cache
def port_pass(max_bounces):
    r, cam = _renderer(SCENE, dict(CONFIG["render"], max_bounces=max_bounces), W, H)
    film = DeviceFilm(W, H, device="cpu")
    r.render(cam, RenderConfig(samples=SPP, subsample=Subsample(1)), film, seed=SEED)
    return film.sum.reshape(-1, 3).clone(), r.rays_traced


def reference_match():
    scene = scene_io.load_scene(SCENE)
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = W / H
    arrays = integrate.scene_arrays(scene, "cpu")
    knobs = {k: v for k, v in CONFIG["render"].items() if k != "output"}
    cfg = integrate.trace_config(scene, arrays, cam, **knobs)
    assert cfg.looped_masses and arrays.n_masses == 64
    sums, counts = integrate.pass_sums(arrays, integrate.camera_params(scene, cam, "cpu"), cfg,
                                       SEED, 0, torch.arange(W * H), W, H, SPP, 1)
    film, rays = port_pass(CONFIG["render"]["max_bounces"])
    assert ((film - sums).abs() <= ATOL + RTOL * sums.abs()).all()
    assert rays == counts["rays"] > 0


def bounces_alike():
    assert CONFIG["render"]["max_bounces"] == 8 and CONFIG["reduced"] == {}
    (a, ra), (b, rb) = port_pass(2), port_pass(8)
    assert torch.equal(a, b) and ra == rb


@functools.cache
def item_iters(scene_name, spp, width=10, height=8):
    """[B, spp] int32: each (lane, sample) item's loop iterations, from the
    plain integrator run one item a lane, as a per-item launch runs them."""
    r, cam = _renderer(f"scenes/{scene_name}.json.gz", {"max_bounces": 2, "output": "full"},
                       width, height)
    cfg = r.trace_config(r.config, cam)
    B = width * height
    lane = torch.arange(B).repeat_interleave(spp)
    res = trace_core(r.arrays, r.camera_params(cam), render_key(SEED, 0), lane,
                     torch.zeros_like(lane), width, height, 1, 1, cfg, spp_total=spp,
                     sample0=torch.arange(spp).repeat(B))
    return res.lane_counts["iters"].to(torch.int32).view(B, spp)


def by_warp(rows):
    """[thread iterations, issued] of launches whose threads' iterations are
    ``rows`` (one tensor a launch, in launch order), warp by warp: each full
    warp of 32 consecutive threads adds its sum and 32 × its longest."""
    use = [0, 0]
    for row in rows:
        xs = row.tolist()
        for w in range(0, len(xs) // 32 * 32, 32):
            use[0] += sum(xs[w:w + 32])
            use[1] += 32 * max(xs[w:w + 32])
    return use


def launch_rows(scene_name, spp, chunk):
    """Per-item launches of ``chunk`` samples (the last one shorter): each
    launch's threads' iterations in launch order, item = lane·s + j."""
    iters = item_iters(scene_name, spp)
    return [iters[:, c0:c0 + chunk].reshape(-1) for c0 in range(0, spp, chunk)]


def cornell_lanes():
    """cornell's lane loop: one thread a lane, the lanes' own iterations."""
    width, height, spp, n = 10, 8, 4, 2
    r, cam = _renderer("scenes/cornell.json.gz", {"max_bounces": 8, "output": "full"}, width,
                       height)
    nn = n * n
    local = torch.arange(width * height * nn)
    res = trace_core(r.arrays, r.camera_params(cam), render_key(SEED, 0), local // nn,
                     local % nn, width, height, spp, n, r.trace_config(r.config, cam))
    return [res.lane_counts["iters"].to(torch.int32)]


def ragged_warp():
    """Two full warps and a ragged one whose long thread no warp issues."""
    return [torch.tensor([1, 5] + [2] * 30 + [3] * 32 + [700] * 5, dtype=torch.int32)]


def warp_count(rows_of, *args):
    """The one host count on each launch's rows (``rows_of(*args)``), through
    ``warp_use_plain`` as the CPU route adds it, against the warps counted
    one by one, and the readers of its sums."""
    rows = rows_of(*args)
    use = torch.zeros(2, dtype=torch.int64)
    for row in rows:
        warp_use_plain(row, use)
    assert use.tolist() == by_warp(rows) and 0 < use[0] <= use[1]
    assert sum(issued(row) for row in rows) == use[1]
    for row in rows:
        got = warp_use(row)
        assert rays_per_warp_issue_slot(2 * row, row) == 2 * int(got[0]) / int(got[1])


def only_while_profiled():
    """An unprofiled pass leaves the renderer's tally and the counters as
    they were; a profiled one adds what its lanes ran."""
    telemetry.clear()
    r, cam = _renderer("scenes/cornell.json.gz", {"max_bounces": 8, "output": "full"}, 8, 8)
    film = DeviceFilm(8, 8, device="cpu")
    rc = RenderConfig(samples=1, subsample=Subsample(1))
    r.render(cam, rc, film, seed=3)
    assert r._counts.tolist() == [0, 0, 0]
    assert telemetry.counters() == {"loop_thread_iters": 0, "loop_issued_iters": 0,
                                    "vol_events": 0}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        r.render(cam, rc, film, seed=4)
    counted = telemetry.counters()
    assert r._counts.tolist() == [counted["loop_thread_iters"], counted["loop_issued_iters"], 0]
    assert 0 < counted["loop_thread_iters"] <= counted["loop_issued_iters"]
    r.render(cam, rc, film, seed=5)
    assert telemetry.counters() == counted
    telemetry.clear()  # forgets the tally and zeroes it, so a later session starts at 0
    assert telemetry.counters() == {"loop_thread_iters": 0, "loop_issued_iters": 0,
                                    "vol_events": 0}
    assert r._counts.tolist() == [0, 0, 0]


CASES = {
    "reference": reference_match,
    "bounces_2_and_8": bounces_alike,
    **{f"items-{s}-spp{spp}-chunk{c}": functools.partial(warp_count, launch_rows, s, spp, c)
       for s in ("mass_cluster", "blackhole") for spp, c in ((1, 1), (4, 4), (4, 3))},
    "lanes-cornell": functools.partial(warp_count, cornell_lanes),
    "ragged-warp": functools.partial(warp_count, ragged_warp),
    "unprofiled": only_while_profiled,
}


@pytest.mark.parametrize("case", list(CASES))
def test_mass_cluster_cell(case):
    CASES[case]()
