"""The port's benchmark (``bendy_tpu_torch/bench.py``) against the
reference's ``bench.py``: the same row table and workload dicts, the same
protocol (fresh seeds, chained passes, rays read after the timed region),
and no timing without a card."""

import glob
import importlib.util
import json
import math
import os

import pytest
import torch

from bendy_tpu.render import Config as RefConfig

from bendy_tpu_torch import Config, Renderer, RenderConfig, Subsample, bench, load_scene
from bendy_tpu_torch.film import DeviceFilm
from bendy_tpu_torch.tools import rays_per_warp_issue_slot
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The reference's rows as bench.py writes them (bench.py:188, 223-341):
# (row, workload label, width, height, spp, subsample, Config kwargs,
#  passes, repeats)
REF_ROWS = [
    ("cornell", "cornell", 256, 256, 64, 2, {}, 4, 7),
    *((n, n, 256, 256, 64, 2, {}, 4, 7)
      for n in ("cornell2", "scene", "volume", "cloud", "dense_cloud")),
    ("blackhole_geodesic", "blackhole", 512, 512, 32, 1, dict(max_bounces=2), 4, 7),
    ("blackhole_cloud", "blackhole_cloud", 512, 288, 32, 1,
     dict(max_bounces=2, volume_step=0.6), 4, 7),
    ("prim_grid_256_looped", "prim_grid_256 (generated)", 256, 256, 16, 1,
     dict(max_bounces=4), 4, 7),
    ("cloud_field_256_looped", "cloud_field (256 volume puffs)", 256, 256, 16, 1,
     dict(max_bounces=4), 4, 7),
    ("mass_cluster_64_looped", "mass_cluster (64 masses)", 256, 256, 16, 1,
     dict(max_bounces=2), 4, 7),
    ("kernel_sharded_1x1", "cornell", 256, 256, 64, 2, {}, 4, 3),
    ("blackhole_1080p_256spp", "blackhole", 1920, 1080, 256, 1, dict(max_bounces=2), 1, 3),
]


def _ref_bench():
    spec = importlib.util.spec_from_file_location("ref_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_rows():
    """(row, label, w, h, spp, sub, Config, passes, repeats) of every port row."""
    rows = [("cornell", "cornell", 256, 256, 64, 2, Config(), 4, 7)]
    for name, _, w, h, spp, sub, cfg, label, passes, repeats, _ in bench.FULL_ROWS:
        rows.append((name, label, w, h, spp, sub, cfg, passes, repeats))
    rows.append(("kernel_sharded_1x1", "cornell", 256, 256, 64, 2, Config(), 4, 3))
    name, _, w, h, spp, sub, cfg, label, passes, repeats, _ = bench.NORTH_STAR
    rows.append((name, label, w, h, spp, sub, cfg, passes, repeats))
    return rows


@pytest.mark.parametrize("i", range(len(REF_ROWS)))
def test_workload_is_the_references(i):
    ref = _ref_bench()
    name, label, w, h, spp, sub, kw, passes, repeats = REF_ROWS[i]
    want = ref.workload(label, w, h, spp, sub, RefConfig(**kw), passes=passes, repeats=repeats)
    assert bench.workload(label, w, h, spp, sub, Config(**kw), passes=passes,
                          repeats=repeats) == want
    port = {r[0]: r for r in _port_rows()}[name]
    assert bench.workload(*port[1:6], port[6], passes=port[7], repeats=port[8]) == want


def test_row_table_is_the_references():
    assert [r[0] for r in _port_rows()] == [r[0] for r in REF_ROWS]
    assert bench.TARGET == _ref_bench().TARGET == 50.0


def test_bench_rows_cover_bundled_scenes():
    """Every bundled scene maps to a row of the committed
    benches_results_torch.json with a finite median, through
    tests/test_scene.py:110-123's mapping, and so does the sharded row;
    the file names its card and power limit."""
    with open(os.path.join(ROOT, "benches_results_torch.json")) as f:
        rows = json.load(f)
    scene_to_row = {
        "cornell": "cornell", "cornell2": "cornell2", "scene": "scene", "volume": "volume",
        "cloud": "cloud", "dense_cloud": "dense_cloud", "cuboid_light": "cornell",
        "blackhole": "blackhole_geodesic", "binary_blackhole": "blackhole_geodesic",
        "blackhole_cloud": "blackhole_cloud", "cloud_field": "cloud_field_256_looped",
        "mass_cluster": "mass_cluster_64_looped",
    }
    bundled = {os.path.basename(p)[: -len(".json.gz")] for p in glob.glob("scenes/*.json.gz")}
    assert bundled <= set(scene_to_row), bundled - set(scene_to_row)
    for row_key in list(scene_to_row.values()) + ["kernel_sharded_1x1"]:
        med = rows[row_key].get("mrays")
        assert med is not None and math.isfinite(med) and med > 0, (row_key, rows[row_key])
    # the reference's rows, and its FP32 utilisation row (bench.py:315-334)
    assert set(rows) - {"_meta"} == {r[0] for r in REF_ROWS} | {"vpu_utilization_cornell"}
    util = rows["vpu_utilization_cornell"]
    assert all(0 < util[k] <= 1 for k in ("fp32_utilization_lo", "fp32_utilization_hi",
                                          "fp32_util_vs_measured_peak"))
    assert "W" in rows["_meta"]["card"] and rows["_meta"]["device"].startswith("cuda")


def test_timed_render_counts_the_renderers_rays():
    """On the CPU: 2 repeats of 2 chained passes count the rays one
    Renderer counts for the same passes at the same seeds."""
    res = bench.timed_render(load_scene("scenes/cornell.json.gz"), 8, 8, 1, 1, repeats=2,
                             passes=2, device="cpu")
    assert len(res["rays"]) == 2 and res["kernel_ms"] is None
    assert res["tracer"] == "trace_surface"
    assert all(v == 0 for v in res["launches"].values())  # the plain versions count nothing
    assert 0 < res["seconds_best"] <= res["seconds_median"]
    assert res["best"] >= res["median"] > 0
    scene = load_scene("scenes/cornell.json.gz")
    cam = scene.find_by_tag("camera")
    r = Renderer(scene, device="cpu")
    for i in range(2):
        film = DeviceFilm(8, 8, device="cpu")
        r.rays_traced = 0
        for p in range(2):
            r.render(cam, RenderConfig(samples=1, subsample=Subsample(1)), film,
                     seed=res["seed"] + 1 + 2 * i + p)
        assert r.rays_traced == res["rays"][i] > 0


def test_occupancy_is_rays_per_warp_issue_slot():
    rays = torch.tensor([4] * 32 + [1] * 32 + [9])
    iters = torch.tensor([4] * 31 + [8] + [2] * 32 + [9])
    # warp 1: 128 rays over 32 x 8 slots; warp 2: 32 over 32 x 2; the tail is left out
    assert rays_per_warp_issue_slot(rays, iters) == 160 / 320
    occ = bench.occupancy(load_scene("scenes/cornell.json.gz"), 16, 16, 2, 1,
                          Config(max_bounces=2), device="cpu")
    assert 0 < occ <= 1


def test_main_needs_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "b.json"
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--full", "--out", str(out)])
    assert not out.exists()
