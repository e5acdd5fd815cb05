"""The prim-scaling and dispatch probes on the CPU (no card, no timing).

``tools/prim_scaling.measure`` forces each route through the trace
configuration, as the reference's ``force_looped`` does: its two routes
render build_prim_grid(256) at 16x16, 2 spp, max_bounces 4 into bit-equal
films with equal rays, since the BVH walk returns the sweep's winner (the
CPU route sweeps either way; the plain walk through the loop,
``trace_core(bvh=...)``, is held to the sweep bit for bit here, as the
kernel's walk is on the card). Also: the forced route in the trace
configuration and the launches' table, the crossover's arithmetic, unknown
routes refused, and the dispatch probe's report of the call that stops a
capture, its scenes and what it takes for a stopped capture.
"""

import pytest
import torch

from bendy_tpu_torch.ops.bvh import bvh_tables
from bendy_tpu_torch.ops.trace_kernel import tracer_table, walks_bvh
from bendy_tpu_torch.ops.wavefront import trace_core
from bendy_tpu_torch.tools import dispatch_probe, prim_scaling
from bendy_tpu_torch.utils.rng import render_key
from torch_threads import one_intra_op_thread  # noqa: F401

N = 256
W = H = 16
SPP = 2


@pytest.fixture(scope="module")
def rows():
    return {route: prim_scaling.measure(N, route, device="cpu", width=W, height=H, spp=SPP,
                                        regions=1, seed=7)
            for route in prim_scaling.ROUTES}


def test_routes_render_bit_equal_films(rows):
    sweep, bvh = rows["sweep"], rows["bvh"]
    assert len(sweep["_films"]) == len(bvh["_films"]) == 2  # the first pass, one region
    for a, b in zip(sweep["_films"], bvh["_films"]):
        assert torch.equal(a.sum, b.sum) and a.passes == b.passes
    assert sweep["rays_regions"] == bvh["rays_regions"] and sweep["rays_regions"][0] > 0
    assert float(sweep["_films"][1].sum.sum()) > 0.0  # something was lit


def test_forced_route_is_in_the_trace_config(rows):
    for route, looped in (("sweep", False), ("bvh", True)):
        row = rows[route]
        assert row["route"] == route and row["looped_sweep"] is looped
        assert row["bvh"] is looped  # build_prim_grid(256)'s tree fits the walk
        assert row["n_field_prims"] == N
        assert row["spheres"] + row["boxes"] + row["trace_rects"] > N
        assert row["kernel_ms"] is None and row["device"] == "cpu"
    r, cam = prim_scaling.forced_renderer(N, "sweep", W, H, "cpu")
    cfg = r.trace_config(r.config, cam)
    assert not cfg.looped_sweep and not walks_bvh(r.arrays, cfg)
    assert "bvh0" not in tracer_table(r.arrays.host_copy(), cfg)[1]
    r, cam = prim_scaling.forced_renderer(8, "bvh", W, H, "cpu")
    cfg = r.trace_config(r.config, cam)
    assert cfg.looped_sweep and walks_bvh(r.arrays, cfg)  # a BVH on 8 spheres too


def test_plain_walk_returns_the_sweeps_winner():
    """What the kernel's BVH route computes, on the CPU: the loop with the
    plain walk in place of the sweep renders the sweep's image bit for bit
    with the same rays."""
    r, cam = prim_scaling.forced_renderer(N, "bvh", W, H, "cpu")
    cfg = r.trace_config(r.config, cam)
    table, counts = tracer_table(r.arrays.host_copy(), cfg)
    pix, sub = torch.arange(W * H), torch.zeros(W * H, dtype=torch.int64)
    args = (r.arrays, r.camera_params(cam), render_key(7, 0), pix, sub, W, H, SPP, 1, cfg)
    sweep = trace_core(*args)
    walk = trace_core(*args, bvh=bvh_tables(table[counts["bvh0"]:], "cpu"))
    for c in "xyz":
        assert torch.equal(getattr(walk.radiance, c), getattr(sweep.radiance, c))
    assert int(walk.rays) == int(sweep.rays)
    assert int(walk.lane_counts["prim_tests"].sum()) < int(sweep.rays) * N  # it culled


def test_crossover():
    def row(route, n, mrays, ms):
        return {"route": route, "n_field_prims": n, "mrays_median": mrays, "kernel_ms": ms}

    rows = [row("sweep", 8, 100.0, 1.0), row("bvh", 8, 80.0, 1.2),
            row("sweep", 64, 60.0, 2.0), row("bvh", 64, 70.0, 1.9),
            row("sweep", 128, 40.0, 3.0), row("bvh", 128, 39.0, 1.8),
            row("sweep", 256, 20.0, 6.0), row("bvh", 256, 60.0, 1.7)]
    assert prim_scaling.crossover(rows, "mrays_median") == 256  # 128 lost again
    assert prim_scaling.crossover(rows, "kernel_ms") == 64
    assert prim_scaling.crossover(rows[:2], "mrays_median") is None


def test_unknown_route_refused():
    with pytest.raises(ValueError, match="unknown route"):
        prim_scaling.forced_renderer(8, "looped", W, H, "cpu")
    with pytest.raises(ValueError, match="unknown route"):
        prim_scaling.measure(8, "unrolled", device="cpu", width=W, height=H, spp=1)


def test_dispatch_probe_names_the_call_that_stops_a_capture():
    from bendy_tpu_torch.ops import trace_kernel

    try:
        trace_kernel.accumulate(torch.zeros(3, 4), torch.zeros(4, dtype=torch.int32), "full", 1,
                                torch.zeros(3, 3), add=True,
                                ray_total=torch.zeros(1, dtype=torch.int64))
    except ValueError as exc:
        where = dispatch_probe.stopped_at(exc)
    assert where.startswith("bendy_tpu_torch/ops/trace_kernel.py:") and " accumulate: " in where
    assert dispatch_probe.stopped_at(ValueError("no traceback")) == "outside bendy_tpu_torch"


def test_dispatch_probe_catches_only_a_stopped_capture():
    assert dispatch_probe.capture_stopped(RuntimeError(
        "CUDA error: operation not permitted when stream is capturing"))
    assert dispatch_probe.capture_stopped(RuntimeError(
        "bendy_accumulate launch failed on cuda:0: CUDA error 901 (operation failed due to a "
        "previous error during capture)"))
    assert not dispatch_probe.capture_stopped(RuntimeError(
        "bendy_trace_surface launch failed on cuda:0: CUDA error 1 (invalid argument)"))


def test_dispatch_probe_scenes_and_refusals():
    """Each scene's pass is its main path's; no other scene is taken."""
    assert dispatch_probe.SCENES == {"cornell": (64, 2, None), "light_field_200": (16, 1, 3)}
    assert dispatch_probe.RES == 256
    with pytest.raises(ValueError, match="unknown scene"):
        dispatch_probe.measure("cloud")
    with pytest.raises(SystemExit):
        dispatch_probe.main(["--scene", "cloud"])
    with pytest.raises(SystemExit):
        dispatch_probe.main(["--res", "64"])
