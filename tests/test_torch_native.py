"""The port's native-oracle binding (``bendy_tpu_torch/native.py``) against
the reference's (``bendy_tpu/native.py``), and the port's CPU renders
against the C++ oracle at the sizes, seeds and thresholds of the
reference's own oracle gates, one test per scene class.

The oracle is the tracked ``native/liboracle.so`` (or a build of
``native/oracle.cpp`` under the port's ``_build/``): a missing oracle
fails these tests, it does not skip them. The port renders on
``device="cpu"`` through the Renderer, one pass keyed ``render_key(seed,
0)`` over the reference's lanes (``pix`` = arange, ``sub`` = 0).
"""

import glob
import os
import sys

import numpy as np
import pytest

from bendy_tpu import native as ref_native
from bendy_tpu.models.prim_grid import build_light_field as ref_light_field
from bendy_tpu.models.prim_grid import build_prim_grid as ref_prim_grid
from bendy_tpu.scene import compile_scene as ref_compile
from bendy_tpu.scene import load_scene as ref_load
from bendy_tpu.scene.io import dumps_scene as ref_dumps

import bendy_tpu_torch as bt
from bendy_tpu_torch import Config, Film, GeoParams, RenderConfig, Renderer, native

BUNDLED = sorted(os.path.basename(p)[: -len(".json.gz")] for p in glob.glob("scenes/*.json.gz"))
GENERATED = {
    "prim_grid_256": (lambda: ref_prim_grid(256), lambda: bt.build_prim_grid(256)),
    "light_field_200": (lambda: ref_light_field(200), lambda: bt.build_light_field(200)),
}


def _scenes(name):
    """(reference Scene, port Scene) of a bundled or generated scene."""
    if name in GENERATED:
        ref, port = GENERATED[name]
        return ref(), port()
    return ref_load(f"scenes/{name}.json.gz"), bt.load_scene(f"scenes/{name}.json.gz")


def test_oracle_loads():
    native._load()
    assert native.available()


@pytest.mark.parametrize("name", BUNDLED + sorted(GENERATED))
def test_pack_scene_byte_equal(name):
    ref_scene, port_scene = _scenes(name)
    want = ref_native.pack_scene(ref_compile(ref_scene))
    got = native.pack_scene(bt.compile_scene(port_scene, device="cpu"))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_oracle_render_equals_the_references():
    """The same call through both bindings gives the same image, bit for
    bit (cloud: spheres, rects, a grid; blackhole: a mass)."""
    for name, mb in (("cloud", 3), ("blackhole", 2)):
        a = native.oracle_render_scene(bt.load_scene(f"scenes/{name}.json.gz"), 8, 8, 8, seed=3,
                                       max_bounces=mb)
        b = ref_native.oracle_render_scene(ref_load(f"scenes/{name}.json.gz"), 8, 8, 8, seed=3,
                                           max_bounces=mb)
        assert a.shape == (8, 8, 3) and np.array_equal(a, b)


def _aspect1(scene):
    cam_ref = scene.find_by_tag("camera")
    scene.get_object(cam_ref).inner.aspect_ratio = 1.0
    return scene, cam_ref


def _ours(scene, cam_ref, size, spp, seed, config):
    """The port's linear mean image of one CPU pass."""
    r = Renderer(scene, config, device="cpu")
    film = Film(size, size)
    r.render(cam_ref, RenderConfig(samples=spp), film, seed=seed)
    return film.mean()


def _rows_cols_corr(a, b):
    return (np.abs((a - b).mean(axis=(1, 2))).max(), np.abs((a - b).mean(axis=(0, 2))).max(),
            np.corrcoef(a.mean(-1).ravel(), b.mean(-1).ravel())[0, 1])


def test_cornell_matches_native_oracle():
    """tests/test_render.py:44-66: cornell without focus, 16², 192 spp,
    max_bounces 2, seed 5, against the oracle at 1024 spp, seed 11."""
    scene, cam_ref = _aspect1(bt.load_scene("scenes/cornell.json.gz"))
    scene.get_object(cam_ref).inner.focus = None
    ours = _ours(scene, cam_ref, 16, 192, 5, Config(max_bounces=2))
    ref = native.oracle_render_scene(scene, 16, 16, 1024, seed=11, max_bounces=2)
    diff = ours - ref
    row_diff = np.abs(diff.mean(axis=(1, 2)))
    bright_row = ref.mean(axis=(1, 2)) > 1.0
    assert row_diff[~bright_row].max() < 0.03, row_diff
    assert row_diff.max() < 0.5, row_diff
    mask = ref.mean(-1) < 3.0  # exclude direct-light pixels
    assert np.abs(diff.mean(-1)[mask]).mean() < 0.02


def test_dense_grid_matches_native_oracle():
    """tests/test_render.py:136: the dense 32³ grid, 16², 48 spp, seed 21,
    against the oracle at 96 spp, seed 14, on smoothed statistics."""
    scene, cam_ref = _aspect1(bt.build_dense_cloud())
    ours = _ours(scene, cam_ref, 16, 48, 21, Config(max_bounces=2))
    ref = native.oracle_render_scene(scene, 16, 16, 96, seed=14, max_bounces=2)
    assert np.abs((ours - ref).mean(axis=(1, 2))).max() < 0.1
    assert np.abs((ours - ref).mean(axis=(0, 2))).max() < 0.1
    assert abs(ours.mean() - ref.mean()) < 0.04

    def blk(im):
        return im.mean(-1).reshape(4, 4, 4, 4).mean(axis=(1, 3))

    assert np.abs(blk(ours) - blk(ref)).max() < 0.08


def test_prim_grid_64_matches_native_oracle():
    """tests/test_render.py:180: build_prim_grid(64), 24², 128 spp,
    max_bounces 3, seed 31, against the oracle at 256 spp, seed 8."""
    scene, cam_ref = _aspect1(bt.build_prim_grid(64))
    ours = _ours(scene, cam_ref, 24, 128, 31, Config(max_bounces=3))
    ref = native.oracle_render_scene(scene, 24, 24, 256, seed=8, max_bounces=3)
    row, col, corr = _rows_cols_corr(ours, ref)
    assert row < 0.08 and col < 0.08, (row, col)
    assert abs(ours.mean() - ref.mean()) < 0.03
    assert corr > 0.97, corr


def test_binary_blackhole_matches_native_oracle():
    """tests/test_geodesic.py:229: binary_blackhole, 24², max_bounces 2,
    seed 6, against the oracle at seed 3, with the trace configuration's
    GeoParams. The spp is halved on both sides, 64 -> 32 and 128 -> 64: at
    64 the port's CPU route takes about 15 s here, 18 s with the oracle."""
    scene, cam_ref = _aspect1(bt.load_scene("scenes/binary_blackhole.json.gz"))
    config = Config(max_bounces=2)
    r = Renderer(scene, config, device="cpu")
    cfg = r.trace_config(r.config, cam_ref)
    assert cfg.geodesic and r.arrays.n_masses == 2
    ours = _ours(scene, cam_ref, 24, 32, 6, config)
    ref = native.oracle_render_scene(scene, 24, 24, 64, seed=3, max_bounces=2, geo=cfg.geo)
    row, _, corr = _rows_cols_corr(ours, ref)
    assert row < 0.1, row
    assert abs(ours.mean() - ref.mean()) < 0.03
    assert corr > 0.92, corr


def test_mass_cluster_matches_native_oracle():
    """tests/test_looped_masses.py:180: the reference's 12-mass ring
    (``multi_mass_scene``, read through the port's loader), looped masses,
    GeoParams(max_steps=96), 24², 32 spp, seed 6, against the oracle at 64
    spp, seed 3."""
    sys.path.insert(0, os.path.dirname(__file__))
    from test_looped_masses import multi_mass_scene

    scene, cam_ref = _aspect1(bt.loads_scene(ref_dumps(multi_mass_scene(12))))
    config = Config(max_bounces=2, geo=GeoParams(max_steps=96))
    r = Renderer(scene, config, device="cpu")
    cfg = r.trace_config(r.config, cam_ref)
    assert cfg.geodesic and cfg.looped_masses and r.arrays.n_masses == 12
    ours = _ours(scene, cam_ref, 24, 32, 6, config)
    ref = native.oracle_render_scene(scene, 24, 24, 64, seed=3, max_bounces=2, geo=cfg.geo)
    row, _, corr = _rows_cols_corr(ours, ref)
    assert row < 0.1, row
    assert abs(ours.mean() - ref.mean()) < 0.03
    assert corr > 0.92, corr


def _against_oracle_spread(ours, ref, ref2):
    """The gates of tests/test_looped_sweep.py:270,355: rows, columns and
    correlation within the oracle's own seed-to-seed spread."""
    row, col, corr = _rows_cols_corr(ours, ref)
    row_c, col_c, corr_c = _rows_cols_corr(ref2, ref)
    assert row < 1.5 * row_c + 0.01, (row, row_c)
    assert col < 1.5 * col_c + 0.01, (col, col_c)
    assert corr > corr_c - 0.01, (corr, corr_c)
    assert abs(ours.mean() - ref.mean()) < 0.03


def test_multi_light_matches_native_oracle():
    """tests/test_looped_sweep.py:270: build_light_field(16), 24², 192
    spp, max_bounces 3, seed 5, against the oracle at 192 spp, seeds 21
    and 77."""
    scene, cam_ref = _aspect1(bt.build_light_field(16))
    ours = _ours(scene, cam_ref, 24, 192, 5, Config(max_bounces=3))
    ref = native.oracle_render_scene(scene, 24, 24, 192, seed=21, max_bounces=3)
    ref2 = native.oracle_render_scene(scene, 24, 24, 192, seed=77, max_bounces=3)
    _against_oracle_spread(ours, ref, ref2)


def test_looped_prim_grid_256_matches_native_oracle():
    """tests/test_looped_sweep.py:355: build_prim_grid(256) (the looped
    sweep), 24², max_bounces 3, seed 31, against the oracle at seeds 8 and
    99. The spp is halved on both sides, 256 -> 128: at 256 the port's CPU
    route takes about 28 s here."""
    scene, cam_ref = _aspect1(bt.build_prim_grid(256))
    r = Renderer(scene, Config(max_bounces=3), device="cpu")
    assert r.trace_config(r.config, cam_ref).looped_sweep
    ours = _ours(scene, cam_ref, 24, 128, 31, Config(max_bounces=3))
    ref = native.oracle_render_scene(scene, 24, 24, 128, seed=8, max_bounces=3)
    ref2 = native.oracle_render_scene(scene, 24, 24, 128, seed=99, max_bounces=3)
    _against_oracle_spread(ours, ref, ref2)


def test_cuboid_light_matches_native_oracle():
    """tests/test_looped_sweep.py:416: build_cuboid_light(), 16², 256 spp,
    max_bounces 3, seed 5, against the oracle at 1024 spp, seed 11, and
    its own noise at 256 spp, seed 77."""
    scene, cam_ref = _aspect1(bt.build_cuboid_light())
    ours = _ours(scene, cam_ref, 16, 256, 5, Config(max_bounces=3))
    ref = native.oracle_render_scene(scene, 16, 16, 1024, seed=11, max_bounces=3)
    ceil = native.oracle_render_scene(scene, 16, 16, 256, seed=77, max_bounces=3)

    def metrics(a):
        d = a - ref
        rows = np.abs(d.mean(axis=(1, 2)))
        bright = ref.mean(axis=(1, 2)) > 1.0
        mask = ref.mean(-1) < 3.0  # exclude direct-light pixels
        return (rows[~bright].max(), np.abs(d.mean(-1)[mask]).mean(),
                abs(float(a.mean() - ref.mean())))

    row, bias, mean_d = metrics(ours)
    row_c, bias_c, _ = metrics(ceil)
    assert row < 1.5 * row_c + 0.01, (row, row_c)
    assert bias < 1.5 * bias_c + 0.005, (bias, bias_c)
    assert mean_d < 0.02, mean_d
    assert ref.mean() > 0.02 and ours.mean() > 0.02
