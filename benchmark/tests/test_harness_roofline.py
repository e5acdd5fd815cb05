"""The frozen floor counts the plain algorithm's operations: each constant of
``benchmark/roofline.py`` is held to a count of the FP32 operations that the
reference's own function performs on a batch of lanes, by the rules that
module states. The floor reads the scene's counts and the reference's work
alone, nothing of the program, so switching the kernel's row sweep or its
rect reject cannot move it."""

import ast
import inspect
import types
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import roofline
from benchmark.reference import geodesic, integrate, intersect, materials, scene_io, volume
from benchmark.reference.v3 import V3

aten = torch.ops.aten
COUNTED = {aten.add, aten.sub, aten.rsub, aten.mul, aten.div, aten.reciprocal, aten.sqrt,
           aten.rsqrt, aten.minimum, aten.maximum, aten.floor, aten.clamp_min, aten.clamp_max}
REDUCED = {aten.amin, aten.amax, aten.sum}


def _is_one(a) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dim() == 0 and a.item() == 1
    return isinstance(a, (int, float)) and a == 1


class OpCount(TorchDispatchMode):
    """FP32 operations per lane of what runs under it: each counted op adds
    its per-lane results (a clamp one a bound, a reduction one a merge);
    results smaller than a lane batch (a primitive's or a mass's own
    values) count none."""

    def __init__(self, lanes: int) -> None:
        super().__init__()
        self.lanes = lanes
        self.ops = 0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = func.overloadpacket
        if not (isinstance(out, torch.Tensor) and out.is_floating_point()
                and out.numel() >= self.lanes):
            return out
        if op in COUNTED and not (op is aten.mul and any(_is_one(a) for a in args)):
            self.ops += out.numel()
        elif op is aten.clamp:
            self.ops += out.numel() * sum(b is not None for b in args[1:3])
        elif op in REDUCED:
            self.ops += args[0].numel() - out.numel()
        return out


def per_lane(make, lanes):
    """Operations per lane of ``make(lanes)()``, counted."""
    fn = make(lanes)
    counter = OpCount(lanes)
    with counter:
        fn()
    assert counter.ops % lanes == 0
    return counter.ops // lanes


def _rand(*shape, seed=0):
    return torch.rand(*shape, generator=torch.Generator().manual_seed(seed))


def _lanes(n, seed=0):
    return V3(_rand(n, seed=seed), _rand(n, seed=seed + 1), _rand(n, seed=seed + 2))


def _prim():
    return V3(torch.tensor(0.5), torch.tensor(-0.25), torch.tensor(2.0))


def sphere(n):
    org, d = _lanes(n), _lanes(n, 3).normalize()
    return lambda: intersect.sphere_t(org, d, 0.01, 1000.0, _prim(), torch.tensor(0.7))


def rect(n):
    org, d = _lanes(n), _lanes(n, 3).normalize()
    return lambda: intersect.rect_t(org, d, 0.01, 1000.0, _prim(), _prim(), _prim(), _prim(),
                                    torch.tensor(1.0), torch.tensor(2.0))


def box(n):
    org, d = _lanes(n), _lanes(n, 3).normalize()
    return lambda: intersect.box_t(org, d, 0.01, 1000.0, _rand(3, 3), _rand(3), _rand(3) + 1.0,
                                   torch.ones(3), -torch.ones(3))


def masses(m):
    return types.SimpleNamespace(mass_center=_rand(m, 3, seed=7) * 5.0, mass_rs=torch.ones(m),
                                 n_masses=m)


def begin(m):
    def make(n):
        x, d, steps = _lanes(n) * 20.0, _lanes(n, 3).normalize(), torch.zeros(n, dtype=torch.int32)
        fn = (geodesic.geo_step_begin_looped if m > roofline.MASS_LOOP_THRESHOLD
              else geodesic.geo_step_begin)
        return lambda: fn(masses(m), x, d, geodesic.GeoParams(), steps=steps)
    return make


def rk4(m):
    def make(n):
        x, d, ds = _lanes(n) * 20.0, _lanes(n, 3).normalize(), _rand(n, seed=9)
        if m > roofline.MASS_LOOP_THRESHOLD:
            return lambda: geodesic.rk4_step_looped(masses(m), x, d, ds)
        h2s = [_rand(n, seed=10 + k) for k in range(m)]
        return lambda: geodesic.rk4_step(masses(m), x, d, ds, h2s=h2s)
    return make


def density(n):
    scn = types.SimpleNamespace(vol_grid=_rand(2, 5, 6, 7))
    hit = types.SimpleNamespace(vol_size=V3(torch.tensor(6.0), torch.tensor(5.0),
                                            torch.tensor(4.0)),
                                vol_grid=torch.ones(n, dtype=torch.int32))
    coord = _lanes(n)
    return lambda: volume.density_sample(scn, hit, coord)


def metallic(n):
    hit = types.SimpleNamespace(
        normal=_lanes(n).normalize(), position=_lanes(n, 3), albedo=_lanes(n, 6),
        mtype=torch.full((n,), 2, dtype=torch.int32), rough=torch.full((n,), 0.3),
        emitted=_lanes(n, 9), t=_rand(n), face=torch.zeros(n, dtype=torch.int32))
    d = _lanes(n, 12).normalize()
    u = [_rand(n, seed=20 + k) for k in range(6)]
    return lambda: materials.shade_surface(d, hit, None, u, 0.01, 1000.0, has_diffuse=False,
                                           has_metallic=True, has_glass=False)


@pytest.mark.parametrize("const,make", [
    ("SPHERE_OPS", sphere), ("RECT_OPS", rect), ("BOX_OPS", box),
    ("DENSITY_OPS", density), ("SCATTER_OPS", metallic)])
def test_event_counts_are_the_references(const, make):
    """A primitive test (the rect's whole test, not a kernel's reject), the
    density lookup and the metallic shade: each constant is what the
    reference's function does per lane, at any number of lanes."""
    assert per_lane(make, 64) == per_lane(make, 96) == getattr(roofline, const)


@pytest.mark.parametrize("m", [1, 2, 3, 9, 10, 16])
def test_geodesic_counts_are_the_references(m):
    """The geodesic sweep and the RK4 step, unrolled and looped masses."""
    assert per_lane(begin(m), 64) == roofline.segment_ops(0, 0, 0, m)
    assert per_lane(rk4(m), 64) == roofline.rk4_ops(m)


def test_segment_ops_sum_the_sweep():
    r = roofline
    assert r.segment_ops(0, 6, 2, 0) == 6 * r.RECT_OPS + 2 * r.BOX_OPS  # cornell's sweep
    assert r.segment_ops(4, 1, 0, 1) == (4 * r.SPHERE_OPS + r.RECT_OPS + r.GEO_BEGIN_OPS
                                         + r.GEO_BEGIN_PER_MASS_OPS)
    # past the loop threshold the search counts one test of the cheapest kind
    assert r.segment_ops(100, 100, 1, 0) == r.SPHERE_OPS


def test_the_floor_reads_nothing_of_the_program():
    """No argument or import of the floor says how the program's kernel
    sweeps; the accumulate's film is no argument of the bytes."""
    tree = ast.parse(Path(inspect.getfile(roofline)).read_text())
    imported = {n.module if isinstance(n, ast.ImportFrom) else a.name
                for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in n.names}
    assert imported <= {"__future__"}
    for fn in (roofline.floor_s, roofline.pass_ops, roofline.segment_ops, roofline.pass_bytes):
        params = set(inspect.signature(fn).parameters)
        assert not params & {"rows", "sweep", "reject", "kernel", "bvh", "pixels"}


@pytest.mark.parametrize("name,spp,n,mb", [("cornell", 4, 2, 8), ("blackhole", 4, 1, 2)])
def test_floor_of_a_reference_pass(name, spp, n, mb):
    scene = scene_io.load_scene(f"scenes/{name}.json.gz")
    cam = scene.find_by_tag("camera")
    arrays = integrate.scene_arrays(scene, "cpu")
    cfg = integrate.trace_config(scene, arrays, cam, max_bounces=mb)
    params = integrate.camera_params(scene, cam, "cpu")
    W = H = 8
    _, c = integrate.pass_sums(arrays, params, cfg, 1, 0, torch.arange(W * H), W, H, spp, n)
    counts = dict(n_sph=arrays.n_spheres, n_rct=arrays.n_trace_rects, n_box=arrays.n_boxes,
                  n_mass=arrays.n_masses, floats=100)
    paths = W * H * n * n * spp
    ops = roofline.pass_ops(counts, c["rays"], paths, c["near_steps"], c["vol_events"])
    seg = roofline.segment_ops(counts["n_sph"], counts["n_rct"], counts["n_box"],
                               counts["n_mass"])
    assert ops >= c["rays"] * seg > 0
    assert (c["near_steps"] > 0) == (name == "blackhole")
    floor, bound = roofline.floor_s(counts, c["rays"], paths, W * H * n * n, c["near_steps"],
                                    c["vol_events"])
    assert bound == "operations" and floor == pytest.approx(ops / roofline.PEAK_F32_S)
