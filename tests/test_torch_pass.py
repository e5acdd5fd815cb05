"""Port: the render pass around the tracer (CPU).

The pass derives its key on Python ints (``utils/rng.render_key``), keeps
its lanes, and hands the tracer's per-lane words to one accumulate
(``ops/trace_kernel.accumulate``: subpixel sum, film add, ray count; the
plain version here) in place of ``pixel_sums``, ``torch.cat`` and the film's
``+=``. A flat table whose tree the kernel's walk cannot hold keeps the
sweep, as the reference's ``nearest_hit_looped`` does at any size.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bendy_tpu_torch as bt
from bendy_tpu.utils import rng as ref_rng
from bendy_tpu_torch import DeviceFilm, Film, RenderConfig, Renderer, Subsample
from bendy_tpu_torch.ops import bvh, trace_kernel
from bendy_tpu_torch.ops.trace_kernel import (accumulate, make_tracer, pass_lanes, pixel_sums,
                                              tracer_table)
from bendy_tpu_torch.ops.wavefront import TraceSums
from bendy_tpu_torch.utils import rng
from bendy_tpu_torch.utils.v3 import V3
from chip_smoke import sphere_field
from torch_threads import one_intra_op_thread  # noqa: F401

OUTPUTS = ("full", "albedo", "normal", "depth")


# --- the key on Python ints ---------------------------------------------------

def test_render_key_on_ints_equals_the_reference_and_the_tensor_form():
    """2,048 seeded (seed, pass) pairs, 0 and 2^32 - 1 among them: the
    integer Threefry equals ``bendy_tpu.utils.rng.render_key`` and the
    tensor ``threefry2x32`` word for word."""
    g = np.random.default_rng(11)
    pairs = g.integers(0, 2**32, size=(2, 2048), dtype=np.uint64).astype(np.uint32)
    pairs[:, :4] = [[0, 0, 2**32 - 1, 2**32 - 1], [0, 2**32 - 1, 0, 2**32 - 1]]
    ref = [np.asarray(k) for k in ref_rng.render_key(jnp.asarray(pairs[0]),
                                                      jnp.asarray(pairs[1]))]
    tensor = rng.threefry2x32(0x9E3779B9, 0xBB67AE85, torch.from_numpy(pairs[0].astype(np.int64)),
                              torch.from_numpy(pairs[1].astype(np.int64)))
    got = np.array([rng.render_key(int(s), int(p)) for s, p in pairs.T], np.int64).T
    for k in range(2):
        np.testing.assert_array_equal(got[k], ref[k].astype(np.int64))
        np.testing.assert_array_equal(got[k], tensor[k].numpy())


def test_render_key_runs_no_torch_op():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        key = rng.render_key(2**32 - 1, 3)
    assert all(isinstance(k, int) for k in key)
    assert [e.key for e in prof.key_averages()] == []


# --- the accumulate against pixel_sums and += --------------------------------

def _words(nn: int, rows: int = 6, width: int = 7, seed: int = 0):
    """Seeded tracer words of rows x width pixels of nn subpixels: [10, B]
    channel sums (non-negative radiance and albedo over six decades, signed
    normals, depth in [0, 1]) and [B] int32 rays."""
    g = np.random.default_rng(seed + nn)
    B = rows * width * nn
    out = g.random((10, B)) * 10.0 ** g.integers(-3, 3, (10, B))
    out[6:9] = g.uniform(-1.0, 1.0, (3, B)) * nn
    out[9] = g.random(B)
    rays = g.integers(0, 400, B).astype(np.int32)
    return torch.from_numpy(out.astype(np.float32)), torch.from_numpy(rays)


def _trace_sums(out: torch.Tensor, rays: torch.Tensor) -> TraceSums:
    zero = torch.zeros((), dtype=torch.int64)
    return TraceSums(V3(out[0], out[1], out[2]), V3(out[3], out[4], out[5]),
                     V3(out[6], out[7], out[8]), out[9], rays.sum(dtype=torch.int64), zero, zero)


def _index_order(out: torch.Tensor, output: str, nn: int) -> np.ndarray:
    """[P, 3] pixel sums in subpixel order, ((s0 + s1) + s2) + ..., in numpy."""
    row0, step = trace_kernel.CHANNEL_ROWS[output]
    w = out.numpy()[[row0, row0 + step, row0 + 2 * step]].reshape(3, -1, nn)
    acc = w[:, :, 0].copy()
    for s in range(1, nn):
        acc = acc + w[:, :, s]
    return acc.T


@pytest.mark.parametrize("nn", [1, 4, 9])
@pytest.mark.parametrize("output", OUTPUTS)
def test_accumulate_against_pixel_sums_and_film_add(output, nn):
    """Add mode: exact against ``film + pixel_sums(...)`` at nn = 1; past it
    ``torch.sum`` may take another order, and the two stay within the bound
    of any two orders of nn - 1 rounded adds, 2 (nn - 1) u sum |x_s| with
    u = 2^-24 (the film add then rounds each once more: one ulp of the
    film). Both modes equal the subpixel-order sum bit for bit, and the ray
    counter gains the lanes' int64 sum."""
    rows, width = 6, 7
    out, rays = _words(nn, rows, width)
    g = np.random.default_rng(5)
    film0 = torch.from_numpy(g.random((rows, width, 3)).astype(np.float32) * 3)
    ref = film0 + pixel_sums(_trace_sums(out, rays), output, rows, width, nn)
    got, total = film0.clone(), torch.full((1,), 17, dtype=torch.int64)
    accumulate(out, rays, output, nn, got, add=True, ray_total=total)
    assert int(total) == 17 + int(rays.sum())
    order = _index_order(out, output, nn).reshape(rows, width, 3)
    np.testing.assert_array_equal(got.numpy(), film0.numpy() + order)
    stored = torch.full((rows, width, 3), np.nan)
    accumulate(out, rays, output, nn, stored, add=False, ray_total=total)
    np.testing.assert_array_equal(stored.numpy(), order)
    if nn == 1:
        assert torch.equal(got, ref)
    else:
        row0, step = trace_kernel.CHANNEL_ROWS[output]
        w = out[[row0, row0 + step, row0 + 2 * step]].view(3, rows, width, nn)
        mags = w.abs().double().sum(dim=3).permute(1, 2, 0).numpy()
        bound = 2 * (nn - 1) * 2.0**-24 * mags * (1 + 1e-6) + np.spacing(np.abs(ref.numpy()))
        assert (np.abs(got.double().numpy() - ref.double().numpy()) <= bound).all()


def test_accumulate_refuses_what_the_kernel_does_not_take():
    out, rays = _words(4)
    dst, total = torch.zeros((6, 7, 3)), torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="unknown output"):
        accumulate(out, rays, "beauty", 4, dst, add=True, ray_total=total)
    with pytest.raises(ValueError, match="row 5"):  # AOVs from a FULL trace's 3 rows
        accumulate(out[:3].contiguous(), rays, "albedo", 4, dst, add=True, ray_total=total)
    with pytest.raises(ValueError, match="accumulate"):  # lanes are not pixels x nn
        accumulate(out, rays, "full", 9, dst, add=True, ray_total=total)
    with pytest.raises(ValueError, match="accumulate"):
        accumulate(out, rays, "full", 4, dst, add=True, ray_total=total.to(torch.int32))


# --- the pass ----------------------------------------------------------------

def test_chunked_cornell_pass_equals_the_whole_and_counts_every_lane_ray(monkeypatch):
    """cornell 16x16, 2x2 subpixels, 2 passes: two row chunks into a
    DeviceFilm (the in-place add) equal one chunk into a host Film (the
    store route) bit for bit, the lanes are built once per chunk, and
    rays_traced is the sum of the tracer's per-lane rays of both passes."""
    built = []

    def counting_lanes(*args):
        built.append(args)
        return pass_lanes(*args)

    monkeypatch.setattr(trace_kernel, "pass_lanes", counting_lanes)
    scene = bt.load_scene("scenes/cornell.json.gz")
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = 1.0
    W = H = 16
    rc = RenderConfig(samples=2, subsample=Subsample(2))
    whole_r = Renderer(scene, bt.Config(max_bounces=3), device="cpu")
    chunked_r = Renderer(scene, bt.Config(max_bounces=3), max_lanes=W * 4 * 8, device="cpu")
    whole, chunked = Film(W, H), DeviceFilm(W, H, device="cpu")
    for _ in range(2):
        whole_r.render(cam, rc, whole, seed=4)
        chunked_r.render(cam, rc, chunked, seed=4)
    assert len(built) == 3  # one chunk, then two: each built at its first pass
    np.testing.assert_array_equal(chunked.sum.numpy(), whole.sum)
    assert (chunked.passes, chunked.samples) == (whole.passes, whole.samples) == (2, 16)
    tracer = make_tracer(whole_r.arrays, W, H, 2, 2, whole_r.trace_config(whole_r.config, cam))
    pix, sub = pass_lanes(W, H, 4, 0, "cpu")
    lane_rays = sum(int(tracer(whole_r._cam_packed, 4, p, pix, sub).lane_counts["rays"].sum())
                    for p in range(2))
    assert chunked_r.rays_traced == whole_r.rays_traced == lane_rays > 0
    chunked_r.rays_traced = 5  # the CLI's resume
    assert chunked_r.rays_traced == 5


# --- the Queue 3 repair: a flat table past the walk keeps the sweep ----------

def test_a_table_past_the_walk_keeps_the_sweep(monkeypatch):
    """140,000 spheres (``chip_smoke.sphere_field``, the table phase 3
    traces on the card): their median tree is 17 deep and the kernel's
    uint16 walk takes 16, so tracer_table appends no node block (the sweep
    instantiation) and builds no tree to find out; a table within the walk
    still gets one."""

    def no_build(*args):
        raise AssertionError("build_bvh ran")

    monkeypatch.setattr(trace_kernel, "build_bvh", no_build)
    arrays, _, cfg = sphere_field(140_000, "cpu")
    assert bvh.uses_bvh(cfg)
    t0 = time.perf_counter()
    table, counts = tracer_table(arrays.host_copy(), cfg)
    assert "bvh0" not in counts and counts["n_sph"] == 140_000
    assert time.perf_counter() - t0 < 15.0
    assert not bvh.tree_fits(140_000) and not bvh.tree_fits(bvh.LEAF_MAX * 2**15 + 1)
    assert bvh.tree_fits(bvh.LEAF_MAX * 2**15)
    small, _, _ = sphere_field(300, "cpu")
    o1 = 300 * bvh.SPH_COLS
    table, counts = trace_kernel.scene_table(small.host_copy())
    blocks = (table[:o1], table[o1:o1 + counts["n_rct"] * bvh.RCT_COLS],
              table[o1 + counts["n_rct"] * bvh.RCT_COLS:][:counts["n_box"] * bvh.BOX_COLS])
    assert bvh.bvh_fits(*blocks)


def test_the_cpu_route_builds_no_table(monkeypatch):
    """make_tracer builds the kernel's table (and a BVH) at the first call
    on a card; the CPU route, the plain sweep, never does, on a table
    within the walk (prim_grid_200) or past it (140,000 spheres, 16 lanes
    of one sample)."""

    def no_table(*args):
        raise AssertionError("tracer_table ran")

    monkeypatch.setattr(trace_kernel, "tracer_table", no_table)
    r = Renderer(bt.build_prim_grid(200), device="cpu")
    cam = r.scene.find_by_tag("camera")
    cfg = r.trace_config(r.config, cam)
    assert cfg.looped_sweep
    r.camera_params(cam)
    pix = torch.arange(16, dtype=torch.int32)
    res = make_tracer(r.arrays, 4, 4, 1, 1, cfg)(r._cam_packed, 1, 0, pix, torch.zeros_like(pix))
    assert int(res.rays) > 0
    arrays, cam_packed, cfg = sphere_field(140_000, "cpu")
    out, rays = make_tracer(arrays, 4, 4, 1, 1, cfg).words(cam_packed, 1, 0, pix,
                                                           torch.zeros_like(pix))
    assert out.shape == (3, 16) and torch.isfinite(out).all() and int(rays.sum()) > 0


@pytest.mark.parametrize("name", ["prim_grid_256", "cloud_field", "light_field_200"])
def test_the_bvh_main_paths_still_walk_the_tree(name):
    """The three looped-sweep main paths keep their node block."""
    scene = {"prim_grid_256": lambda: bt.build_prim_grid(256),
             "light_field_200": lambda: bt.build_light_field(200)}.get(
        name, lambda: bt.load_scene(f"scenes/{name}.json.gz"))()
    r = Renderer(scene, device="cpu")
    cfg = r.trace_config(r.config, scene.find_by_tag("camera"))
    _, counts = tracer_table(r.arrays.host_copy(), cfg)
    assert "bvh0" in counts and counts["n_node"] > 0
