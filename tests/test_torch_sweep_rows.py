"""The tracer's sweep over float4 rows (``csrc/trace_surface.cu``,
``nearest_hit_rows``: the surface segments and the geodesic chords),
rehearsed on the CPU.

The kernel's source up to its phase stubs (its device functions: every
intersection test, the flat sweep, the rows' layout and the row sweep)
compiles with g++ as plain C++ (``-ffp-contract=off``: IEEE float
arithmetic without contraction, as ``--fmad=false`` builds it), with a
small header in place of ``cuda_runtime.h``. A small runner program runs seeded numpy
rays (points in the scene's bounds, rays aimed at primitives, axis-parallel
and grazing rays, then rays from the hits found) through both sweeps:

- on every bundled scene's table and ``build_prim_grid(64)``'s, the row
  sweep against the flat sweep of the same source, bit for bit (t, face,
  material, position, normal, colour, rough, ior);
- on the geodesic scenes' tables (blackhole, binary_blackhole,
  mass_cluster), the same under a chord's short clip: rays on and near the
  accretion ring's plane, rays grazing the spheres, chords ending at a
  hit's t;
- on cornell, cornell2 and scene.json (the surface kernel's main paths),
  the row sweep against the port's plain ``intersect.nearest_hit`` (t and
  face bit for bit) and the reference's (rtol 5e-4, atol 1e-5, the
  reference's own kernel contract; equal faces).

The measuring build (``-DBENDY_SWEEP_STATS``: its rect counter compiled
in) sweeps as the flat sweep does. ``quotient_may_win`` (the test that says
a rect's t can no longer win) is held to its margin with a numpy
stand-in of its float32 operations, its approximate reciprocal pushed to
both ends of its stated error (2 ulp), on seeded and edge cases: it never
says "cannot" where the correctly rounded ``p / q`` passes t >= cmin,
t <= cmax and t < t_best. The same stand-in without its margin fails.
The SASS listing parser of ``tools/sweep_sass.py`` is held to small
listings of both tools' formats, through ``chip_smoke.sass_counts`` too.
The staging rule (which instantiations sweep rows, which the host counts
rows for) and the register budgets are read from the source's own
definitions, built with g++.
"""

import os
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bendy_tpu.ops import intersect as ref_isect
from bendy_tpu.render import Renderer as RefRenderer
from bendy_tpu.scene import load_scene as ref_load
from bendy_tpu.utils.v3 import V3 as JV3
from bendy_tpu_torch import Renderer, build_prim_grid, load_scene
from bendy_tpu_torch._build import trace_label
from bendy_tpu_torch.ops import intersect
from bendy_tpu_torch.ops.trace_kernel import scene_table
from bendy_tpu_torch.scene.compiler import compile_scene
from bendy_tpu_torch.tools import sweep_sass
from bendy_tpu_torch.utils.v3 import V3
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "bendy_tpu_torch", "csrc", "trace_surface.cu")
SCENES = ["binary_blackhole", "blackhole", "blackhole_cloud", "cloud", "cloud_field", "cornell",
          "cornell2", "cuboid_light", "dense_cloud", "mass_cluster", "scene", "volume"]
MAIN = ["cornell", "cornell2", "scene"]
N_RAYS = 4096
RTOL, ATOL = 5e-4, 1e-5
CLIP = (0.01, 1000.0)
REC = 14  # t, face, mtype, position xyz, normal xyz, colour rgb, rough, ior

SHIM = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
struct alignas(16) float4 { float x, y, z, w; };
typedef void* cudaStream_t;
template <class T> inline T __ldg(const T* p) { return *p; }
using std::max;
using std::min;
float rcp_hook(float q);
#ifdef BENDY_SWEEP_STATS
struct uint3 { unsigned x, y, z; };
static const uint3 threadIdx = {0, 0, 0};
inline unsigned __activemask() { return 1u; }
inline unsigned __ballot_sync(unsigned, bool b) { return b ? 1u : 0u; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const unsigned long long o = *p;
  *p += v;
  return o;
}
#endif
"""

RUNNER = r"""
#include "sweep.inc"
#include <cstdio>
#include <cstdlib>
#include <vector>
static int mode = 0;  // the approximate reciprocal: 0 rounded, 1 -2 ulp, 2 +2 ulp
float rcp_hook(float q) {
  float r = 1.0f / q;
  for (int k = 0; k < 2 && mode; ++k) r = nextafterf(r, mode == 1 ? -INFINITY : INFINITY);
  return r;
}
static void put(float* o, const Hit& h) {
  const float v[REC] = {h.t, (float)h.face, (float)h.mtype, h.position.x, h.position.y,
                        h.position.z, h.normal.x, h.normal.y, h.normal.z, h.color.x, h.color.y,
                        h.color.z, h.rough, h.ior};
  memcpy(o, v, sizeof(v));
}
int main(int argc, char** argv) {
  mode = atoi(argv[4]);
  FILE* f = fopen(argv[1], "rb");
  int hdr[4];
  if (fread(hdr, 4, 4, f) != 4) return 2;
  const int ns = hdr[0], nr = hdr[1], nb = hdr[2], nf = hdr[3];
  std::vector<float> table(nf);
  if (fread(table.data(), 4, nf, f) != (size_t)nf) return 2;
  fclose(f);
  const int R = sweep_rows_floats(ns, nr, nb);
  std::vector<float4> buf((R + nf) / 4 + 2);
  float* base = reinterpret_cast<float*>(buf.data());
  for (int e = 0; e < R; ++e) base[e] = sweep_row_word(table.data(), ns, nr, e);
  memcpy(base + R, table.data(), 4 * (size_t)nf);
  f = fopen(argv[2], "rb");
  std::vector<float> rays;
  float r8[8];
  while (fread(r8, 4, 8, f) == 8) rays.insert(rays.end(), r8, r8 + 8);
  fclose(f);
  const size_t n = rays.size() / 8;
  std::vector<float> out(n * 2 * REC);
  BvhState<false> walk;
  for (size_t i = 0; i < n; ++i) {
    const float* r = &rays[8 * i];
    const V3 org = {r[0], r[1], r[2]}, dir = {r[3], r[4], r[5]};
    put(&out[2 * REC * i], nearest_hit<false, false, false>(table.data(), ns, nr, nb, r[6], r[7],
                                                            org, dir, false, -1, walk));
    put(&out[2 * REC * i + REC], nearest_hit_rows(base + R, ns, nr, nb, r[6], r[7], org, dir));
  }
  f = fopen(argv[3], "wb");
  fwrite(out.data(), 4, out.size(), f);
  fclose(f);
#ifdef BENDY_SWEEP_STATS
  printf("%llu %llu %llu\n", sweep_stats[0], sweep_stats[1], sweep_stats[2]);
#endif
  return 0;
}
"""


def extract(source: str) -> str:
    """The source up to its phase stubs, as plain C++: rcp.approx through
    the runner's ``rcp_hook``."""
    text = source.split("// ---- phase stubs")[0]
    text, n = re.subn(r'asm\("rcp\.approx\.ftz\.f32 %0, %1;" : "=f"\(r\) : "f"\(q\)\);',
                      "r = rcp_hook(q);", text)
    assert n == 1, "the approximate reciprocal is not where the rehearsal expects it"
    return text.replace("#include <cuda_runtime.h>", '#include "shim.h"') + "}  // namespace\n"


def build(tmp, name: str, stats: bool = False) -> str:
    """The runner, or with ``stats`` the measuring build's (its rect
    counter compiled in)."""
    d = tmp / name
    d.mkdir()
    (d / "shim.h").write_text(SHIM)
    with open(SOURCE) as f:
        (d / "sweep.inc").write_text(f"#define REC {REC}\n" + extract(f.read()))
    (d / "runner.cpp").write_text(RUNNER)
    exe = str(d / "runner")
    subprocess.run([shutil.which("g++") or "g++", "-std=c++17", "-O1", "-ffp-contract=off",
                    "-fno-fast-math", "-w", *(["-DBENDY_SWEEP_STATS"] * stats), f"-I{d}", "-o",
                    exe, str(d / "runner.cpp")],
                   check=True, capture_output=True, text=True, timeout=120)
    return exe


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sweep_rows")
    return {"plain": build(tmp, "plain"), "stats": build(tmp, "stats", stats=True)}


def scene_of(name: str):
    return build_prim_grid(64) if name == "prim_grid_64" else load_scene(
        os.path.join(ROOT, "scenes", f"{name}.json.gz"))


def table_of(name: str):
    table, counts = scene_table(compile_scene(scene_of(name), device="cpu").host_copy())
    return table, counts


def primitive_points(table, counts):
    """Each sphere's and rect's centre, and each box's (its slab normals are
    orthonormal: the sum of n_i times its slabs' mid-planes)."""
    ns, nr, nb = counts["n_sph"], counts["n_rct"], counts["n_box"]
    sph = table[:15 * ns].reshape(ns, 15)
    rct = table[15 * ns:15 * ns + 21 * nr].reshape(nr, 21)
    box = table[15 * ns + 21 * nr:15 * ns + 21 * nr + 28 * nb].reshape(nb, 28)
    mid = (box[:, 9:12] + box[:, 12:15]) / 2
    boxes = np.einsum("kij,ki->kj", box[:, :9].reshape(nb, 3, 3), mid)
    small = sph[sph[:, 3] < 10.0, :3]  # not scene.json's ground
    return np.concatenate([small, rct[:, :3], boxes]).astype(np.float32)


def first_rays(g, points, n: int) -> np.ndarray:
    """[n, 8] rays (org, dir, cmin, cmax): a quarter from points in the
    padded bounds of ``points`` in random directions, a quarter aimed at a
    point near one of them, a quarter axis-parallel or grazing (a direction
    component at 0 or 1e-5), a quarter with a short clip."""
    lo, hi = points.min(0), points.max(0)
    pad = 0.2 * (hi - lo) + 0.5
    org = lo - pad + g.uniform(0, 1, (n, 3)) * (hi - lo + 2 * pad)
    d = g.normal(size=(n, 3))
    q = n // 4
    aim = points[g.integers(0, len(points), q)] + g.uniform(-0.15, 0.15, (q, 3))
    d[q:2 * q] = aim - org[q:2 * q]
    axis = g.integers(0, 3, q)
    d[2 * q:3 * q] = 0.0
    d[2 * q + np.arange(q), axis] = g.choice([-1.0, 1.0], q)
    d[2 * q + np.arange(q), (axis + 1) % 3] = g.choice([0.0, 1e-5, -1e-5, 3e-5], q)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    clip = np.tile(np.float32(CLIP), (n, 1))
    clip[3 * q:] = np.stack([np.zeros(n - 3 * q), g.uniform(0.5, 10.0, n - 3 * q)], axis=1)
    return np.concatenate([org, d, clip], axis=1).astype(np.float32)


def run(exe, tmp, table, counts, rays, mode: int = 0, checks: list | None = None) -> np.ndarray:
    """[n, 2, REC]: the flat sweep's and the row sweep's hit of each ray
    (``checks``: the measuring build's runner appends its counts, the rect
    tests, lane skips and warp skips)."""
    tf, rf, of = (str(tmp / f) for f in ("table.bin", "rays.bin", "out.bin"))
    hdr = np.int32([counts["n_sph"], counts["n_rct"], counts["n_box"], table.size])
    with open(tf, "wb") as f:
        f.write(hdr.tobytes() + table.astype(np.float32).tobytes())
    rays.astype(np.float32).tofile(rf)
    proc = subprocess.run([exe, tf, rf, of, str(mode)], check=True, timeout=120,
                          capture_output=True, text=True)
    if checks is not None:
        checks.append([int(v) for v in proc.stdout.split()])
    return np.fromfile(of, np.float32).reshape(len(rays), 2, REC)


def rays_and_hits(exe, tmp, name: str, mode: int = 0, seed: int = 0, checks=None):
    """Two rounds of rays (the second from the first's hits, in random
    directions, as a bounce leaves a surface) and their hits."""
    table, counts = table_of(name)
    g = np.random.default_rng(seed + sum(map(ord, name)))
    rays = first_rays(g, primitive_points(table, counts), N_RAYS)
    hits = run(exe, tmp, table, counts, rays, mode, checks)
    on = hits[:, 0, 1] >= 0
    d = g.normal(size=(int(on.sum()), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bounce = np.concatenate([hits[on, 0, 3:6], d, np.tile(np.float32(CLIP), (len(d), 1))], axis=1)
    rays = np.concatenate([rays, bounce.astype(np.float32)])
    return table, counts, rays, run(exe, tmp, table, counts, rays, mode, checks)


@pytest.mark.parametrize("name", SCENES + ["prim_grid_64"])
def test_row_sweep_matches_flat_sweep(runners, tmp_path, name):
    _, _, rays, hits = rays_and_hits(runners["plain"], tmp_path, name)
    flat, rows = hits[:, 0].view(np.uint32), hits[:, 1].view(np.uint32)
    off = np.flatnonzero((flat != rows).any(axis=1))
    assert off.size == 0, f"{name}: {off.size} of {len(rays)} rays differ, first {rays[off[0]]}"
    assert (hits[:, 0, 1] >= 0).mean() > 0.1  # the rays do hit


def chord_rays(g, table, counts, n: int, cmin: float) -> np.ndarray:
    """[n, 8] rays under a geodesic chord's clip [cmin, |chord|], |chord|
    log-uniform over the step rule's [0.02, 30]: a third from on and near
    the y = 0 plane of blackhole's accretion ring (y at 0, ±1e-6, ±1e-3 or
    within ±0.5), half of them nearly in the plane and some in it; a third
    grazing a sphere (impact parameter within 1e-3 of its radius, both
    sides, up to 3 before the tangent point); a third of ``first_rays``."""
    ns = counts["n_sph"]
    sph = table[:15 * ns].reshape(ns, 15)
    k = n // 3
    org = np.empty((n, 3))
    d = g.normal(size=(n, 3))
    org[:k, 0], org[:k, 2] = g.uniform(-9, 9, k), g.uniform(-9, 9, k)
    org[:k, 1] = np.where(g.uniform(0, 1, k) < 0.5, g.choice([0.0, 1e-6, -1e-6, 1e-3, -1e-3], k),
                          g.uniform(-0.5, 0.5, k))
    d[:k // 2, 1] *= g.choice([0.0, 1e-6, 1e-3, 1e-2], k // 2)
    s = sph[g.integers(0, ns, k)]
    v = g.normal(size=(k, 3))
    d[k:2 * k] /= np.linalg.norm(d[k:2 * k], axis=1, keepdims=True)
    u = np.cross(d[k:2 * k], v)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    b = s[:, 3] * (1 + g.uniform(-1e-3, 1e-3, k))
    org[k:2 * k] = s[:, :3] + u * b[:, None] - d[k:2 * k] * g.uniform(0, 3, (k, 1))
    rest = first_rays(g, primitive_points(table, counts), n - 2 * k)
    org[2 * k:], d[2 * k:] = rest[:, :3], rest[:, 3:6]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    clip = np.stack([np.full(n, cmin), np.exp(g.uniform(np.log(0.02), np.log(30.0), n))], axis=1)
    return np.concatenate([org, d, clip], axis=1).astype(np.float32)


@pytest.mark.parametrize("cmin", [0.0, 0.01])
@pytest.mark.parametrize("name", ["blackhole", "binary_blackhole", "mass_cluster"])
def test_row_sweep_matches_flat_sweep_on_chords(runners, tmp_path, name, cmin):
    """The geodesic item kernel's chords: the row sweep against the flat
    sweep, bit for bit, with the approximate reciprocal rounded and 2 ulp
    either side, and in the measuring build (one count a rect and ray).
    Besides the drawn chords, each ray that hits within the longest chord
    again with its chord ending at that hit's t, moved 0-2 ulp either way."""
    table, counts = table_of(name)
    g = np.random.default_rng(60 + sum(map(ord, name)) + int(cmin * 100))
    rays = chord_rays(g, table, counts, N_RAYS, cmin)
    edge = rays.copy()
    edge[:, 7] = 30.0
    t = run(runners["plain"], tmp_path, table, counts, edge)[:, 0]
    edge = edge[t[:, 1] >= 0]
    end, step = t[t[:, 1] >= 0, 0], g.integers(-2, 3, len(edge))
    for _ in range(2):
        end = np.where(step != 0, np.nextafter(end, np.where(step > 0, F(np.inf), F(-np.inf))), end)
        step -= np.sign(step)
    edge[:, 7] = end
    rays = np.concatenate([rays, edge])
    for mode in (0, 1, 2):
        checks = []
        for kind in ("plain", "stats"):
            hits = run(runners[kind], tmp_path, table, counts, rays, mode,
                       checks if kind == "stats" else None)
            off = np.flatnonzero((hits[:, 0].view(np.uint32) != hits[:, 1].view(np.uint32)).any(1))
            assert off.size == 0, (f"{name} cmin {cmin} mode {mode} {kind}: {off.size} rays "
                                   f"differ, first {rays[off[0]]}")
        assert checks[0][0] == counts["n_rct"] * len(rays)
    hit = hits[:, 0, 1] >= 0
    assert 0.05 < hit.mean() < 0.95  # chords that end short of a primitive, and chords that hit
    if counts["n_rct"]:  # the ring: hits in its plane, and rect tests that reject
        assert (hit & (np.abs(hits[:, 0, 4]) < 1e-3)).sum() > 50
        tests, lane, _ = checks[0]
        assert 0 < lane < tests


@pytest.mark.parametrize("mode", [1, 2])
def test_row_sweep_with_approximate_reciprocal_at_its_ends(runners, tmp_path, mode):
    """The rect reject's approximate reciprocal 2 ulp below (mode 1) and 2
    ulp above (mode 2) the rounded one: the winners stay the flat sweep's,
    bit for bit."""
    for name in ["cornell", "cuboid_light", "blackhole", "prim_grid_64"]:
        _, _, rays, hits = rays_and_hits(runners["plain"], tmp_path, name, mode, seed=mode)
        off = np.flatnonzero((hits[:, 0].view(np.uint32) != hits[:, 1].view(np.uint32)).any(1))
        assert off.size == 0, f"{name} mode {mode}: {off.size} rays differ"


@pytest.mark.parametrize("mode", [1, 2])
def test_measuring_build_sweeps_as_the_flat_sweep(runners, tmp_path, mode):
    """The measuring build (its rect counter in the row sweep), its
    reciprocal at both ends: the winners stay the flat sweep's, bit for
    bit, and it counts one test per rect and ray, its skips among them (a
    lane of one: a lane's skip is its warp's)."""
    for name in ["cornell", "cornell2", "cuboid_light", "prim_grid_64"]:
        checks = []
        _, counts, rays, hits = rays_and_hits(runners["stats"], tmp_path, name, mode,
                                              seed=3 + mode, checks=checks)
        assert (hits[:, 0].view(np.uint32) == hits[:, 1].view(np.uint32)).all()
        first, (tests, lane, warp) = checks  # a run of the first rays, then of all
        assert first[0] == counts["n_rct"] * N_RAYS and tests == counts["n_rct"] * len(rays)
        assert lane == warp and 0 < lane < tests


def tv3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def jv3(a):
    return JV3(*(jnp.asarray(a[:, i]) for i in range(3)))


@pytest.mark.parametrize("name", MAIN)
def test_row_sweep_matches_plain_and_reference(runners, tmp_path, name):
    _, _, rays, hits = rays_and_hits(runners["plain"], tmp_path, name, seed=5)
    org, d = rays[:, :3], rays[:, 3:6]
    cmin, cmax = torch.from_numpy(rays[:, 6].copy()), torch.from_numpy(rays[:, 7].copy())
    port = intersect.nearest_hit(tv3(org), tv3(d), cmin, cmax,
                                 Renderer(scene_of(name), device="cpu").arrays)
    rows = hits[:, 1]
    assert np.array_equal(port.face.numpy(), rows[:, 1].astype(np.int64))
    assert np.array_equal(port.t.numpy().view(np.uint32), rows[:, 0].view(np.uint32))
    ref_r = RefRenderer(ref_load(os.path.join(ROOT, "scenes", f"{name}.json.gz")),
                        use_pallas=False)
    ref = ref_isect.nearest_hit(jv3(org), jv3(d), jnp.asarray(rays[:, 6]),
                                jnp.asarray(rays[:, 7]), ref_r.arrays)
    assert np.array_equal(np.asarray(ref.face), rows[:, 1].astype(np.int32))
    on = rows[:, 1] >= 0
    np.testing.assert_allclose(rows[on, 0], np.asarray(ref.t)[on], rtol=RTOL, atol=ATOL)


RULE_MAIN = r"""
#include <cstdio>
#define __host__
#define __device__
constexpr int BLOCK = BENDY_TRACE_BLOCK;
%(decls)s
bool host_staged(int flags, int volumes) { return %(staged)s; }
bool host_occupancy(int flags, int volumes) { return %(occupancy)s; }
template <bool A, bool G, bool V, bool L, bool T, bool B>
void row() {
  const int flags = (G ? FLAG_GEO : 0) | (L ? FLAG_LOOPM : 0) | (T ? FLAG_GTAB : 0) | (B ? FLAG_BVH : 0);
  printf("%%d %%d %%d %%d %%d %%d %%d %%d %%d %%d\n", A, G, V, L, T, B, MIN_BLOCKS<A, G, V, L, T, B>,
         (int)SWEEP_ROWS<V, T, B>, (int)host_staged(flags, V), (int)host_occupancy(flags, V));
}
template <int I = 0>
void rows() {
  if constexpr (I < 64) {
    constexpr bool A = I & 1, G = I & 2, V = I & 4, L = I & 8, T = I & 16, B = I & 32;
    // the instantiations: LOOPM with geodesics, and the lane pool (LOOPM's slot
    // without them) in FULL output with the table staged
    if constexpr ((!(L && !G) || (!A && !V && !T && !B)) && !(B && G)) row<A, G, V, L, T, B>();
    rows<I + 1>();
  }
}
int main() { rows(); }
"""


def staging_rule(tmp_path, block: int) -> dict:
    """{(aovs, geo, vol, loopm, gtab, bvh): (MIN_BLOCKS, SWEEP_ROWS, the
    rows bendy_staged_floats counts, the rows bendy_item_occupancy counts)}
    over every instantiation the kernel has, from the source's own
    definitions and host expressions, built with g++ at ``block`` threads."""
    with open(SOURCE) as f:
        src = f.read()
    decls = [re.search(r"constexpr int FLAG_DIFFUSE.*?;", src, re.S).group(0),
             re.search(r"__host__ __device__ constexpr bool sweeps_rows\(.*?\n}", src, re.S).group(0)]
    for name in ("SWEEP_ROWS", "PER_ITEM", "MIN_BLOCKS"):
        decls.append(re.search(r"template <[^>]*>\s*constexpr \w+ %s =.*?;" % name, src,
                               re.S).group(0))
    staged = re.search(r"int bendy_staged_floats\(.*?staged_floats\(P, (.*?)\);\n", src, re.S)
    occupancy = re.search(r"int bendy_item_occupancy\(.*?dynamic_smem\(P, false, (.*?)\);\n", src,
                          re.S)
    d = tmp_path / f"rule{block}"
    d.mkdir()
    (d / "main.cpp").write_text(RULE_MAIN % {"decls": "\n".join(decls), "staged": staged.group(1),
                                             "occupancy": occupancy.group(1)})
    exe = str(d / "main")
    subprocess.run(["g++", "-std=c++17", "-w", f"-DBENDY_TRACE_BLOCK={block}", "-o", exe,
                    str(d / "main.cpp")], check=True, timeout=120)
    out = subprocess.run([exe], capture_output=True, text=True, check=True, timeout=60).stdout
    table = {}
    for ln in out.split("\n"):
        if ln:
            v = [int(x) for x in ln.split()]
            table[tuple(map(bool, v[:6]))] = tuple(v[6:])
    return table


@pytest.mark.parametrize("block", [128, 256])
def test_staging_rule(tmp_path, block):
    """One rule for the rows: the kernel's SWEEP_ROWS, the rows that
    bendy_staged_floats counts for the wrapper's GTAB choice and those that
    bendy_item_occupancy stages. Rows for every geodesic flag set without
    media or the BVH (LOOPM among them, and GTAB, whose floats are counted
    as the launch would stage them), none for media or the BVH, and a GTAB
    instantiation sweeps the flat table in place. The register budgets
    (MIN_BLOCKS) stay as they were: the item instantiations 768 / BLOCK
    (640 with media), the surface one in FULL output with its table staged
    1024 / BLOCK and the lane pool with it, LOOPM and every other 0."""
    table = staging_rule(tmp_path, block)
    # AOVS x GTAB x the eight (GEO, VOL, LOOPM, BVH) routes, and the lane pool
    assert len(table) == 2 * 2 * 8 + 1
    for (aovs, geo, vol, loopm, gtab, bvh), (budget, rows, staged, occ) in table.items():
        want_rows = not vol and not bvh
        assert staged == want_rows and occ == (not vol), (geo, vol, loopm, gtab, bvh)
        assert rows == (want_rows and not gtab), (geo, vol, loopm, gtab, bvh)
        if loopm and not geo:  # the lane pool: the surface one's budget
            want = 1024 // block
        elif loopm:
            want = 0
        elif geo or (vol and not bvh):  # the item instantiations
            want = (640 if geo and vol else 768) // block
        elif not aovs and rows:  # the surface one, FULL output, table staged
            want = 1024 // block
        else:
            want = 0
        assert budget == want, (aovs, geo, vol, loopm, gtab, bvh, budget)
    # the geodesic main path (kernel 1d, FULL output, table staged) sweeps
    # rows under the item budget; LOOPM sweeps rows with none
    assert table[False, True, False, False, False, False] == (768 // block, 1, 1, 1)
    assert table[False, True, False, True, False, False] == (0, 1, 1, 1)
    assert table[False, False, False, True, False, False] == (1024 // block, 1, 1, 1)


def test_sweep_rows_floats_and_layout(tmp_path):
    """The host's count of the staged rows is the kernel's, and each row
    holds its primitive's flat fields where the source's note puts them."""
    with open(SOURCE) as f:
        src = f.read()
    table, counts = table_of("cuboid_light")  # spheres, rects and a box
    ns, nr, nb = counts["n_sph"], counts["n_rct"], counts["n_box"]
    d = tmp_path / "layout"
    d.mkdir()
    (d / "shim.h").write_text(SHIM)
    (d / "sweep.inc").write_text(f"#define REC {REC}\n" + extract(src))
    (d / "main.cpp").write_text(r"""
#include "sweep.inc"
#include <cstdio>
float rcp_hook(float q) { return 1.0f / q; }
int main() {
  static float t[1 << 16];
  int h[4];
  fread(h, 4, 4, stdin);
  fread(t, 4, h[3], stdin);
  printf("%d\n", sweep_rows_floats(h[0], h[1], h[2]));
  for (int e = 0; e < sweep_rows_floats(h[0], h[1], h[2]); ++e)
    printf("%.9g\n", sweep_row_word(t, h[0], h[1], e));
}
""")
    exe = str(d / "main")
    subprocess.run(["g++", "-std=c++17", "-O1", "-w", f"-I{d}", "-o", exe, str(d / "main.cpp")],
                   check=True, timeout=120)
    hdr = np.int32([ns, nr, nb, table.size])
    out = subprocess.run([exe], input=hdr.tobytes() + table.tobytes(), capture_output=True,
                         check=True, timeout=60).stdout.decode().split()
    assert int(out[0]) == 4 * ns + 16 * (nr + nb)
    rows = np.float32(out[1:])
    sph = table[:15 * ns].reshape(ns, 15)
    rct = table[15 * ns:15 * ns + 21 * nr].reshape(nr, 21)
    box = table[15 * ns + 21 * nr:15 * ns + 21 * nr + 28 * nb].reshape(nb, 28)
    zero = np.zeros(1, np.float32)
    want = [sph[:, :4].reshape(-1)]
    for r in rct:  # center, hw | zb, hh | xb, 0 | yb, 0
        want.append(np.concatenate([r[0:3], r[12:13], r[9:12], r[13:14], r[3:6], zero, r[6:9],
                                    zero]))
    for b in box:  # n0, dlo0 | n1, dlo1 | n2, dlo2 | dhi, 0
        want.append(np.concatenate([b[0:3], b[9:10], b[3:6], b[10:11], b[6:9], b[11:12],
                                    b[12:15], zero]))
    assert np.array_equal(rows, np.concatenate(want))


# --- quotient_may_win's margin -----------------------------------------------

F = np.float32
REL, ABS = F(1.0 / 1048576.0), F(1.1754943508222875e-38)
EPS_PAR = F(1e-5)


def may_win(a, cmin, cmax, t_best, rel=REL, abs_=ABS):
    """quotient_may_win in float32, operation for operation."""
    with np.errstate(all="ignore"):
        m = np.abs(a) * rel + abs_
        return ~((a + m < cmin) | (a - m > cmax) | (a - m >= t_best))


def rcp_ends(q):
    """The correctly rounded 1/q pushed 2 ulp down and 2 ulp up."""
    r = F(1) / q
    lo, hi = r, r
    for _ in range(2):
        lo, hi = np.nextafter(lo, F(-np.inf)), np.nextafter(hi, F(np.inf))
    return lo, hi


def cases(kind: str, g) -> tuple:
    """Seeded (p, q, cmin, cmax, t_best) float32 cases."""
    n = 20000
    sign = g.choice([F(-1), F(1)], n)
    q = (sign * F(10) ** g.uniform(-4.99, 0.0, n)).astype(F)
    p = (g.choice([F(-1), F(1)], n) * F(10) ** g.uniform(-6, 3, n)).astype(F)
    if kind == "eps":  # |q| one and two ulp past EPS_PAR
        q = (sign * np.nextafter(EPS_PAR, F(1))).astype(F)
        q[::2] = sign[::2] * np.nextafter(np.nextafter(EPS_PAR, F(1)), F(1))
    if kind == "denormal":  # p below the normal range
        p = (g.choice([F(-1), F(1)], n) * g.uniform(1e-45, 1e-38, n)).astype(F)
    with np.errstate(all="ignore"):
        t = (p / q).astype(F)
    cmin = g.uniform(0.0, 0.02, n).astype(F)
    cmax = F(10) ** g.uniform(0, 3, n).astype(F)
    t_best = np.where(g.uniform(0, 1, n) < 0.3, F(np.inf), F(10) ** g.uniform(-2, 3, n)).astype(F)
    if kind in ("edges", "eps", "denormal"):  # t on and beside each bound
        which = g.integers(0, 3, n)
        nudge = g.integers(-2, 3, n)
        at = t.copy()
        for k in range(n):
            v = at[k]
            for _ in range(abs(nudge[k])):
                v = np.nextafter(v, F(np.inf) if nudge[k] > 0 else F(-np.inf))
            at[k] = v
        cmin = np.where(which == 0, at, np.minimum(cmin, at)).astype(F)
        cmax = np.where(which == 1, at, np.maximum(cmax, at)).astype(F)
        t_best = np.where(which == 2, at, t_best).astype(F)
    return p, q, cmin, cmax, t_best


@pytest.mark.parametrize("kind", ["random", "edges", "eps", "denormal"])
def test_quotient_margin_never_rejects_a_winner(kind):
    g = np.random.default_rng(["random", "edges", "eps", "denormal"].index(kind) + 40)
    p, q, cmin, cmax, t_best = cases(kind, g)
    keep = np.abs(q) > EPS_PAR
    p, q, cmin, cmax, t_best = (a[keep] for a in (p, q, cmin, cmax, t_best))
    with np.errstate(all="ignore"):
        t = (p / q).astype(F)
    passes = (t >= cmin) & (t <= cmax) & (t < t_best)
    assert passes.sum() > len(p) // 20  # the cases reach the bounds
    for r in rcp_ends(q):
        with np.errstate(all="ignore"):
            a = (p * r).astype(F)
        bad = passes & ~may_win(a, cmin, cmax, t_best)
        assert not bad.any(), (f"{kind}: {bad.sum()} winners rejected, first p {p[bad][0]!r} "
                               f"q {q[bad][0]!r}")
    if kind in ("random", "edges"):  # and it rejects the clear losers
        assert (~may_win((p * (F(1) / q)).astype(F), cmin, cmax, t_best) & ~passes).sum() > 0


def test_quotient_margin_is_needed():
    """Without the margin the stand-in rejects winners: the cases reach it."""
    g = np.random.default_rng(41)
    p, q, cmin, cmax, t_best = cases("edges", g)
    with np.errstate(all="ignore"):
        t = (p / q).astype(F)
    passes = (t >= cmin) & (t <= cmax) & (t < t_best) & (np.abs(q) > EPS_PAR)
    bad = 0
    for r in rcp_ends(q):
        with np.errstate(all="ignore"):
            a = (p * r).astype(F)
        bad += (passes & ~may_win(a, cmin, cmax, t_best, F(0), F(0))).sum()
    assert bad > 0


# --- the SASS counts ------------------------------------------------------------

LISTING = """
//--------------------- .text._ZN4xx12trace_kernelILb0ELb0ELb0ELb0ELb0ELb0EEEvNS_6ParamsE ----
.text._ZN4xx12trace_kernelILb0ELb0ELb0ELb0ELb0ELb0EEEvNS_6ParamsE:
\t//## File "trace_surface.cu", line 3
        /*0000*/                   LDS.128 R4, [R2] ;
.L_x_1:
\t//## File "trace_surface.cu", line 4
        /*0010*/                   LDS.128 R8, [R2+0x10] ;
        /*0020*/                   FMUL R3, R4, R8 ;
        /*0030*/                   FADD R3, R3, R9 ;
        /*0040*/               @!P0 FSEL R5, R3, R6, P1 ;
        /*0050*/                   MUFU.RCP R7, R3 ;
        /*0060*/                   BSSY B0, `(.L_x_2) ;
        /*0070*/                   CALL.REL.NOINC `($slowpath) ;
.L_x_2:
        /*0080*/                   BSYNC B0 ;
        /*0090*/                   LDS R1, [R2+0x20] ;
\t//## File "trace_surface.cu", line 2
        /*00a0*/                   IADD3 R20, R20, -0x2, RZ ;
        /*00b0*/                   ISETP.NE.AND P2, PT, R20, RZ, PT ;
        /*00c0*/               @P2 BRA `(.L_x_1) ;
//--------------------- .text._ZN4xx5otherEv ----
"""


def test_sweep_sass_counts_a_listing():
    source = "x\n  for (int k = 0; k < n_rct; ++k) {\n"
    assert sweep_sass.loop_lines(source)["rect"] == {2}
    counts = sweep_sass.sweep_counts(LISTING, source)
    assert set(counts) == {"rect"}
    rect = counts["rect"]
    assert rect["unroll"] == 2 and rect["trips_found"] == 1
    assert rect["instructions"] == 6.0  # 12 instructions a trip, 2 iterations
    assert (rect["LDS.128"], rect["LDS"], rect["FMUL"], rect["FSEL"], rect["MUFU"]) == (
        0.5, 0.5, 0.5, 0.5, 0.5)
    assert (rect["CALL"], rect["BSSY/BSYNC"], rect["BRA"]) == (0.5, 1.0, 0.5)
    assert sweep_sass.same_code(LISTING, LISTING.replace("R20", "R21"))
    assert not sweep_sass.same_code(LISTING, LISTING.replace("FADD", "FMUL"))


def test_same_tracers_finds_each_instantiation_in_another_library():
    """Every tracer instantiation of one listing held to the same mangled
    name in another (whose anonymous namespace differs): its opcodes, or
    None where the other lacks it; other functions are left out."""
    loopm = LISTING.replace("ILb0ELb0ELb0ELb0ELb0ELb0E", "ILb0ELb1ELb0ELb1ELb0ELb0E")
    mine = LISTING + loopm
    theirs = (LISTING + loopm.replace("FADD", "FMUL")).replace("4xx", "5yyyy")
    surface, looped = (trace_label(0, g, 0, g, 0, 0) for g in (0, 1))
    assert sweep_sass.same_tracers(mine, theirs) == {surface: True, looped: False}
    assert sweep_sass.same_tracers(mine, LISTING) == {surface: True, looped: None}
    # the lane pool, in the LOOPM slot without geodesics, is named apart
    pool = LISTING.replace("ILb0ELb0ELb0ELb0ELb0ELb0E", "ILb0ELb0ELb0ELb1ELb0ELb0E")
    assert sweep_sass.same_tracers(LISTING + pool, LISTING) == {
        surface: True, trace_label(0, 0, 0, 1, 0, 0): None}


def test_sweep_sass_counts_the_geodesic_instantiation(monkeypatch, tmp_path):
    """sass_counts counts the geodesic item instantiation beside the
    surface one, and holds both to the library's opcodes."""
    geo = LISTING.replace("ILb0ELb0ELb0ELb0ELb0ELb0E", "ILb0ELb1ELb0ELb0ELb0ELb0E").replace(
        "LDS.128 R8", "LDS R8")
    listing = LISTING + geo
    source = "x\n  for (int k = 0; k < n_rct; ++k) {\n"
    monkeypatch.setattr(sweep_sass, "library_listing", lambda lib: listing)
    res = sweep_sass.sass_counts(lib=tmp_path, listing=(listing, source))
    assert res["lineinfo_matches_library"] is True
    assert res["loops"]["rect"]["LDS.128"] == 0.5 and res["loops"]["rect"]["LDS"] == 0.5
    assert res["geodesic"]["instantiation"].startswith("trace_kernel<AOVS=0,GEO=1,VOL=0")
    assert res["geodesic"]["loops"]["rect"]["LDS.128"] == 0 and res["geodesic"]["loops"]["rect"][
        "LDS"] == 1.0
    monkeypatch.setattr(sweep_sass, "library_listing", lambda lib: LISTING + geo.replace(
        "FADD", "FMUL"))
    assert sweep_sass.sass_counts(lib=tmp_path, listing=(listing, source))[
        "lineinfo_matches_library"] is False


# cuobjdump's format: branches to addresses, an encoding line after each
# instruction; a dot chain whose HGMMA loop (0x10-0x40) sits in an outer
# loop (0x00-0x60), and an FP32 chain
CUOBJDUMP = """
\t\tFunction : _ZN4xx21bf16_dot_chain_kernelILi64ELi64EEEvPKf
        /*0000*/                   LDG.E R2, [R4.64] ;          /* 0x0000000004027981 */
                                                                /* 0x000ea2000c1e1900 */
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;  /* 0x00 */
                                                                /* 0x000fe20008000818 */
        /*0020*/                   F2FP.BF16.F32.PACK_AB R6, R24, R25 ;  /* 0x0000001918067231 */
        /*0030*/                   FADD R8, R8, R24 ;           /* 0x0000001808087221 */
        /*0040*/               @P0 BRA 0x10 ;                   /* 0xfffffffc00f00947 */
        /*0050*/                   LDS R1, [R2] ;               /* 0x0000000002017984 */
        /*0060*/               @P1 BRA 0x0 ;                    /* 0xfffffffc00e41947 */
        /*0070*/                   EXIT ;                       /* 0x000000000000794d */
\t\tFunction : _ZN4xx16fp32_chain_kernelILb1EEEvPKf
        /*0000*/                   FFMA R1, R2, R3, R1 ;        /* 0x0000000302017223 */
        /*0010*/                   FFMA R1, R2, R3, R1 ;        /* 0x0000000302017223 */
        /*0020*/                   FADD R1, R1, R4 ;            /* 0x0000000401017221 */
        /*0030*/                   EXIT ;                       /* 0x000000000000794d */
"""


def test_sweep_sass_reads_address_branches():
    """cuobjdump's branches go to addresses: the parser finds the same
    natural loops as from labels."""
    ins, labels = sweep_sass.instructions(sweep_sass.function(CUOBJDUMP, "ILi64ELi64EEEvPKf"))
    assert [sweep_sass.opcode(t) for _, t in ins][:2] == ["LDG.E", "HGMMA.64x64x16.F32.BF16"]
    found = sorted(idx for idx, _ in sweep_sass.loops(ins, labels))
    assert found == [[0, 1, 2, 3, 4, 5, 6], [1, 2, 3, 4]]


def test_chip_smoke_sass_counts_use_the_parser(monkeypatch):
    """chip_smoke's probe counts: the innermost loop that holds an HGMMA,
    and the FP32 chain's whole function."""
    import chip_smoke
    from bendy_tpu_torch import _build

    monkeypatch.setattr(sweep_sass, "library_listing", lambda lib: CUOBJDUMP)
    monkeypatch.setattr(_build, "build", lambda *a, **k: ("lib", 0.0))
    counts = chip_smoke.sass_counts()
    assert counts["fma"] == {"FFMA": 2, "FADD": 1}
    assert counts["dot BN=64 KS=64"] == {"HGMMA": 1, "F2FP": 1, "FADD": 1, "LDS": 0, "LDG": 0,
                                         "loop_instructions": 4, "function_HGMMA": 1}
