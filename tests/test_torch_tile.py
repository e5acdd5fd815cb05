"""Tile-major lane order on the CPU: the port's ``tile_perm`` and tiled
``pass_lanes`` against the reference's ``tile_perm`` and ``lane_order``
(``bendy_tpu/ops/pallas_trace.py``) on the geometries of
tests/test_pallas.py; a tiled render pass and a tiled (1,1) sharded pass
bit-equal to row-major ones (the counterparts of test_pallas.py's
megakernel tile-order tests); the accumulate's plain version on tiled lanes
against a numpy scatter; and the lanes per block of each route."""

import numpy as np
import pytest
import torch

from bendy_tpu.ops.pallas_trace import lane_order as ref_lane_order
from bendy_tpu.ops.pallas_trace import tile_perm as ref_tile_perm
from bendy_tpu_torch import Config, Renderer, _build
from bendy_tpu_torch.ops.trace_kernel import (accumulate, lanes_per_block, make_render_pass,
                                              pass_lanes, tile_perm)
from bendy_tpu_torch.ops.wavefront import TraceConfig
from bendy_tpu_torch.scene import load_scene
from torch_threads import one_intra_op_thread  # noqa: F401

# tests/test_pallas.py:397-439: (width, rows, nn, lanes per block)
CASES = [
    (256, 256, 4, 16 * 128), (256, 256, 1, 16 * 128),
    (1920, 36, 1, 16 * 128), (1920, 1080, 1, 16 * 128),
    (512, 288, 1, 16 * 128), (64, 40, 4, 2 * 128),
    (320, 200, 9, 8 * 128), (48, 48, 1, 1 * 128),
    (1000, 100, 1, 16 * 128), (1000, 100, 4, 16 * 128),
    (100, 64, 1, 2 * 128), (333, 50, 1, 8 * 128),
]


@pytest.mark.parametrize("width,rows,nn,lanes", CASES)
def test_tile_perm_and_lanes_equal_the_references(width, rows, nn, lanes):
    perm, tiling = tile_perm(width, rows, nn, lanes)
    ref_perm, ref_tiling = ref_tile_perm(width, rows, nn, lanes)
    assert ref_perm is not None  # every geometry of the reference's test tiles
    assert np.array_equal(perm, ref_perm) and tiling == ref_tiling
    ref_pix, ref_sub, _ = ref_lane_order(width, rows, nn, lanes)
    y0 = 7  # global pixel ids: a chunk starting at row 7
    pix, sub = pass_lanes(width, rows, nn, y0, "cpu", tile=True, lanes_per_block=lanes)
    assert pix.dtype == sub.dtype == torch.int32
    assert np.array_equal(pix.numpy(), np.asarray(ref_pix).astype(np.int64) + y0 * width)
    assert np.array_equal(sub.numpy(), np.asarray(ref_sub))


def test_tile_perm_declines_as_the_reference():
    """Blocks narrower than a pixel's subpixels, or tiles as wide as the
    image: no permutation, and pass_lanes stays row-major."""
    for args in ((64, 40, 4, 2), (16, 16, 1, 1024), (256, 3, 1, 128)):
        assert tile_perm(*args) == ref_tile_perm(*args) == (None, None)
    pix, sub = pass_lanes(64, 40, 4, 2, "cpu", tile=True, lanes_per_block=2)
    row_pix, row_sub = pass_lanes(64, 40, 4, 2, "cpu")
    assert torch.equal(pix, row_pix) and torch.equal(sub, row_sub)
    with pytest.raises(ValueError, match="lanes_per_block"):
        pass_lanes(64, 40, 4, 2, "cpu", tile=True)


def test_lanes_per_block_by_route():
    """The lane loop's blocks hold the build's threads; a per-item launch's
    hold threads over the samples it traces per lane."""
    lanes = 256 * 256
    assert lanes_per_block(TraceConfig(), False, lanes * 4, 64) == _build.TRACE_BLOCK == 128
    assert lanes_per_block(TraceConfig(has_volumes=True), True, lanes, 16) == 128  # BVH
    assert lanes_per_block(TraceConfig(has_volumes=True), False, lanes * 4, 64) == 2
    assert lanes_per_block(TraceConfig(geodesic=True), False, 512 * 512, 32) == 4
    assert lanes_per_block(TraceConfig(geodesic=True, looped_masses=True), False, lanes, 16) == 8
    with _build.trace_block(256):
        assert lanes_per_block(TraceConfig(), False, lanes * 4, 64) == 256
        assert lanes_per_block(TraceConfig(geodesic=True), False, 512 * 512, 32) == 8
    assert _build.TRACE_BLOCK == 128
    with pytest.raises(ValueError, match="whole warps"):
        with _build.trace_block(100):
            pass


def _cornell(W, H):
    scene = load_scene("scenes/cornell.json.gz")
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = W / H
    r = Renderer(scene, Config(max_bounces=2), device="cpu")
    r.camera_params(cam)
    return r, r.trace_config(r.config, cam)


@pytest.mark.parametrize("W,H", [(32, 32), (32, 24), (24, 32)])
def test_tiled_render_pass_bit_equal(W, H):
    """The RNG is keyed on (pixel, sample, subpixel) values and the
    accumulate puts each pixel's sum in its own film row: a tiled pass is
    bit-equal to a row-major one, with equal rays. At 256 threads a block
    the tiles are the reference test's 16 x 16 (2 x 128 lanes): H = 24
    leaves trailing rows, W = 24 a ragged right edge."""
    r, cfg = _cornell(W, H)
    with _build.trace_block(256):
        perm, tiling = tile_perm(W, H, 1, 256)
        assert perm is not None and tiling == ref_tile_perm(W, H, 1, 2 * 128)[1]
        fns = [make_render_pass(r.arrays, W, H, H, 2, 1, cfg, "full", tile=t)
               for t in (False, True)]
        outs = [f(r._cam_packed, 5, 0, 0) for f in fns]
        lanes = fns[1].lanes(0, "cpu")[0]
    assert np.array_equal(lanes.numpy(), perm)
    assert tiling[2] < H or tiling[3] < W or (W, H) == (32, 32)
    assert int(outs[0][1]) == int(outs[1][1]) > 0
    assert torch.equal(outs[0][0], outs[1][0])


def test_tiled_sharded_pass_bit_equal():
    """A (1,1) gloo mesh in this process: the tiled sharded pass equals the
    row-major one bit for bit, rays included."""
    import torch.distributed as dist

    from bendy_tpu_torch.parallel import initialize, make_kernel_pass_sharded, make_mesh
    from bendy_tpu_torch.parallel.multihost import free_port

    W, H = 32, 24
    r, cfg = _cornell(W, H)
    initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="gloo", device="cpu", timeout_s=60.0)
    try:
        mesh = make_mesh(1, 1, "cpu")
        outs = [make_kernel_pass_sharded(r.arrays, mesh, W, H, 2, 2, cfg, "full", tile=t)(
            r._cam_packed, 9, 0) for t in (False, True)]
    finally:
        dist.destroy_process_group()
    assert int(outs[0][1]) == int(outs[1][1]) > 0
    assert torch.equal(outs[0][0], outs[1][0])


@pytest.mark.parametrize("nn", [1, 4])
@pytest.mark.parametrize("add", [True, False])
def test_accumulate_plain_on_tiled_lanes_is_a_scatter(nn, add):
    """Each tiled pixel's subpixel sum lands in its own film row, added in
    subpixel order: equal to a numpy scatter of the same sums; rays exact."""
    rows, W, y0 = 37, 29, 5
    g = np.random.default_rng(nn)
    B = rows * W * nn
    out = (g.standard_normal((10, B)) * 10.0 ** g.integers(-4, 4, (10, B))).astype(np.float32)
    rays = g.integers(0, 500, B).astype(np.int32)
    film = g.random((rows, W, 3)).astype(np.float32)
    pix, _ = pass_lanes(W, rows, nn, y0, "cpu", tile=True, lanes_per_block=128)
    assert not torch.equal(pix, pass_lanes(W, rows, nn, y0, "cpu")[0])
    for output, first, step in (("full", 0, 1), ("normal", 6, 1), ("depth", 9, 0)):
        got = torch.from_numpy(film.copy())
        total = torch.full((1,), 3, dtype=torch.int64)
        accumulate(torch.from_numpy(out), torch.from_numpy(rays), output, nn, got, add=add,
                   ray_total=total, pix=pix, pix0=y0 * W)
        sums = np.zeros((rows * W, 3), np.float32)
        for c in range(3):
            words = out[first + c * step].reshape(-1, nn)
            acc = words[:, 0].copy()
            for s in range(1, nn):
                acc = acc + words[:, s]
            sums[:, c] = acc
        want = film.reshape(-1, 3).copy() if add else np.zeros((rows * W, 3), np.float32)
        slots = pix.numpy()[::nn] - y0 * W
        if add:
            want[slots] = want[slots] + sums
        else:
            want[slots] = sums
        assert np.array_equal(got.numpy().reshape(-1, 3).view(np.int32), want.view(np.int32))
        assert int(total) == 3 + int(rays.astype(np.int64).sum())
