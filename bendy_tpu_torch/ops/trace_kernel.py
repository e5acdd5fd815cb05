"""The tracer as one CUDA kernel per pass, and its launch glue.

Counterpart of ``bendy_tpu/ops/pallas_trace.py``: ``make_tracer`` stands
for ``make_pallas_tracer`` and ``make_render_pass`` for
``make_pallas_render_pass``. The kernel is ``csrc/trace_surface.cu``, a
hand-written CUDA C++ kernel for sm_90a that runs the whole regenerating
wavefront loop of :func:`bendy_tpu_torch.ops.wavefront.trace_core`, one
thread per lane or per (lane, sample) (below). That function is its plain
version. The kernel has
compile-time instantiations behind three entry points, each with its own
launch count: the flat surface tracer (:func:`trace_surface`), the
geodesic one (:func:`trace_geodesic`, RK4 chord stepping over up to
``MAX_MASSES`` unrolled masses, or with ``cfg.looped_masses`` over any
count of masses in a loop that recomputes h² per RK4 stage: the LOOPM
instantiations) and the volume one (:func:`trace_volume`: march mode and
the density lookup of sparse and dense grids, with or without geodesics,
unrolled or looped). Primitives and lights are swept by run-time loops
over the table in every instantiation, so the reference's looped
primitive and light sweeps need no instantiation of their own. Geodesics
and media without the BVH (:func:`per_item`) run one thread per (lane,
sample) item instead (the LOOPM and the item instantiations), so that a
lane's long samples spread over threads and no thread carries a quota of
samples, under a register budget that fits more warps per SM (the LOOPM
ones start a resident grid whose threads take the next item from a pool
when their path ends, :func:`pools_items`); a second
kernel (:func:`fold_samples`) adds each lane's samples in sample order,
bit-equal to one thread per lane. A render pass (:func:`make_render_pass`)
then runs one more kernel, :func:`accumulate` (``csrc/accumulate.cu``),
which sums each pixel's subpixels into the film and counts the rays.

Dispatch is by the device of the lane tensors and by ``cfg.has_volumes``,
``cfg.geodesic`` and ``cfg.looped_masses``, with no fallback: CUDA tensors launch the matching
kernel (a build or launch failure raises), CPU tensors run the plain
version, anything else raises.

The scene is not baked into the kernel (the TPU kernel recompiles on any
scene value change): :func:`scene_table` flattens the compiled tables into
one f32 buffer with run-time counts, which the kernel stages into shared
memory (or, past ``MAX_TABLE_BYTES``, reads in place from global memory),
and the geodesic knobs (``GeoParams``) are launch arguments, so
editing a scene or its ``geodesic`` block rebuilds nothing. The density
grids go to the kernel as their own contiguous ``[G, D, H, W]`` f32
buffer with the four extents as launch arguments: a 32³ grid (128 KiB)
would crowd the shared-memory table.

A render pass feeds its lanes row-major, or with ``tile`` in the
reference's tile-major order (:func:`tile_perm`), which gives each block
of a launch a square-ish tile of pixels; the accumulate kernel reads each
pixel's film row from the lanes' own pixel ids, and the RNG is keyed on
the (pixel, sample, subpixel) values, so both orders render the same
film bit for bit. The tracer's threads per block are a build parameter
(``_build.TRACE_BLOCK``, 128 unless a build asks for another).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from bendy_tpu_torch import telemetry
from bendy_tpu_torch.geodesic import GeoParams
from bendy_tpu_torch.ops.bvh import (BOX_COLS, BVH_STACK, RCT_COLS, SPH_COLS, build_bvh,
                                     bvh_counts, bvh_fits, uses_bvh)
from bendy_tpu_torch.ops.camera import CameraParams
from bendy_tpu_torch.ops.wavefront import TraceConfig, TraceSums, check_trace_args, trace_core
from bendy_tpu_torch.scene.compiler import MAT_EMISSIVE, MAT_FLAT, SceneArrays
from bendy_tpu_torch.utils.rng import render_key
from bendy_tpu_torch.utils.v3 import V3

N_OUT = 10  # rx ry rz ax ay az nx ny nz dep
# shared memory one block can use on sm_90: a larger scene table is read in
# place from global memory (the GTAB instantiations)
MAX_TABLE_BYTES = 227 * 1024

MAX_MASSES = 8  # the geodesic kernel's mass unroll (render.MASS_LOOP_THRESHOLD)

# the lane order of a render pass unless its caller asks (make_render_pass,
# parallel/mesh.make_kernel_pass_sharded): row-major. On an H100 80GB HBM3
# at 700 W, tools/block_sweep.py at 128 threads and the main paths' shapes
# timed the tracer alone on the six lane-loop paths at 25.83 ms summed
# tiled against 24.28 row-major: scene.json ran 3.9 % faster tiled, but
# prim_grid_256 and cloud_field (16 spp, 1x1: one wave of 512 blocks, whose
# time is the slowest block's) 14 % and 12 % slower, their block tails up
# from 1.50 and 1.89 to 1.63 and 2.22 (PERF.md §6)
TILE = False

# kernel flag bits (csrc/trace_surface.cu FLAG_*)
FLAG_DIFFUSE, FLAG_METALLIC, FLAG_GLASS, FLAG_DOF, FLAG_POLY, FLAG_GEO = 1, 2, 4, 8, 16, 32
FLAG_LOOPM = 64  # the looped mass sweep (the LOOPM instantiations)
FLAG_GTAB = 128  # the scene table stays in global memory
FLAG_BVH = 256  # nearest hits by the BVH walk (the looped-sweep scenes, ops/bvh.py)

# a per-item launch (:func:`per_item`) traces each (lane, sample) into
# per-item buffers of n_out floats and N_COUNTS int32 counts (rays, iters,
# vevents, near_steps); past SPLIT_BUDGET_BYTES of them the wrapper launches
# the samples in chunks (at 1080p, 256 spp they would take 28 GB), each of
# at most MAX_ITEMS items (the kernel numbers them in int32). 1 GiB takes
# cloud's and dense_cloud's 64 samples a lane in one launch and one fold a
# pass: on an H100 80GB HBM3 at 700 W the tracer with its folds ran 2.5 %
# and 0.8 % faster than at 256 MiB (36 + 28 samples), now that the fold of
# 64 samples (0.124 ms) costs less than the two of 36 and 28 (0.137 ms)
# (PERF.md §6)
N_COUNTS = 4
SPLIT_BUDGET_BYTES = 1 << 30
MAX_ITEMS = 2**31 - 1


def pack_camera_host(sensor, focal, aspect, fstop, focus, yfov,
                     rotation, translation) -> np.ndarray:
    """Camera scalars -> [1,32] f32 (the layout of ``bendy_tpu``'s packed
    camera: scalars, row-major rotation, translation); keep in lockstep
    with :func:`unpack_camera` and the kernel's reads."""
    vec = np.zeros((1, 32), np.float32)
    vec[0, :6] = [sensor, focal, aspect, fstop, focus, yfov]
    vec[0, 6:15] = np.asarray(rotation, np.float32).reshape(-1)
    vec[0, 15:18] = np.asarray(translation, np.float32)
    return vec


def unpack_camera(v: torch.Tensor) -> CameraParams:
    return CameraParams(
        sensor_size=v[0, 0],
        focal_length=v[0, 1],
        aspect_ratio=v[0, 2],
        fstop=v[0, 3],
        focus=v[0, 4],
        rotation=v[0, 6:15].reshape(3, 3),
        translation=v[0, 15:18],
        yfov=v[0, 5],
    )


def pack_aux(key: tuple, sample0: int = 0, n_valid: int = 0) -> np.ndarray:
    """(key0, key1, sample0, n_valid) as the reference's [1,8] u32 aux row."""
    aux = np.zeros((1, 8), np.uint32)
    aux[0, :4] = [key[0], key[1], sample0, n_valid]
    return aux


def scene_table(host: SceneArrays) -> tuple[np.ndarray, dict]:
    """Compiled scene -> (flat f32 table, counts) for the kernel.

    Blocks in order, row-major, unpadded (the column layouts of the
    reference's ``intersect.prim_tables``; csrc/trace_surface.cu reads
    them by these offsets):
      sph   [Ns,15]: center xyz, radius, mtype, merged color rgb, rough,
                     ior, vol_grid, vol_size xyz, valid
      rct   [Nt,21]: center xyz, x-basis xyz, y-basis xyz, z-basis xyz, hw,
                     hh, mtype, merged color rgb, rough, ior, valid
      box   [Nb,28]: slab normals 3x3, dlo xyz, dhi xyz, sgn_lo xyz, sgn_hi
                     xyz, mtype, merged color rgb, rough, ior, valid
      light [L,5+23F]: kind, sphere center xyz, radius, then per face:
                     center, fx, fy, ux, uy, z (xyz each), hw, hh, area,
                     cdf, valid
      env   [7]:     root mtype, albedo rgb, emitted rgb
      mass  [M,4]:   center xyz, rs (geodesic masses; M = 0 in flat scenes)
    The merged color is ``emitted`` for Flat/Emissive and ``albedo``
    otherwise (the one rgb shading reads, ``intersect._color_rows``).
    """
    f32 = np.float32

    def merged(mtype, albedo, emitted):
        is_em = (mtype == MAT_FLAT) | (mtype == MAT_EMISSIVE)
        return np.where(is_em[:, None], emitted, albedo)

    def col(a):
        return np.asarray(a, f32)[:, None]

    ns, nt, nb, nl = (host.sph_radius.shape[0], host.rct_traced.shape[0],
                      host.box_rough.shape[0], host.light_kind.shape[0])
    F = host.light_face_cdf.shape[1]
    sph = np.concatenate([
        host.sph_center, col(host.sph_radius), col(host.sph_mtype),
        merged(host.sph_mtype, host.sph_albedo, host.sph_emitted),
        col(host.sph_rough), col(host.sph_ior), col(host.sph_vol_grid),
        host.sph_vol_size, np.ones((ns, 1), f32),
    ], axis=1)
    r = slice(0, nt)
    rct = np.concatenate([
        host.rct_center[r], host.rct_x[r], host.rct_y[r], host.rct_z[r],
        col(host.rct_hw[r]), col(host.rct_hh[r]), col(host.rct_mtype[r]),
        merged(host.rct_mtype[r], host.rct_albedo[r], host.rct_emitted[r]),
        col(host.rct_rough[r]), col(host.rct_ior[r]), np.ones((nt, 1), f32),
    ], axis=1)
    box = np.concatenate([
        host.box_n.reshape(nb, 9), host.box_dlo, host.box_dhi, host.box_sgn_lo,
        host.box_sgn_hi, col(host.box_mtype),
        merged(host.box_mtype, host.box_albedo, host.box_emitted),
        col(host.box_rough), col(host.box_ior), np.ones((nb, 1), f32),
    ], axis=1)
    light_cols = [col(host.light_kind), host.light_sph_center, col(host.light_sph_radius)]
    for f in range(F):
        light_cols += [
            host.light_face_center[:, f], host.light_face_x[:, f],
            host.light_face_y[:, f], host.light_face_ux[:, f],
            host.light_face_uy[:, f], host.light_face_z[:, f],
            col(host.light_face_hw[:, f]), col(host.light_face_hh[:, f]),
            col(host.light_face_area[:, f]), col(host.light_face_cdf[:, f]),
            col(host.light_face_valid[:, f]),
        ]
    light = np.concatenate(light_cols, axis=1)
    env = np.concatenate([[f32(host.root_mtype)], host.root_albedo, host.root_emitted])
    mass = np.concatenate([host.mass_center, col(host.mass_rs)], axis=1)
    assert sph.shape[1] == 15 and rct.shape[1] == 21 and box.shape[1] == 28
    assert light.shape[1] == 5 + 23 * F and mass.shape[1] == 4
    table = np.concatenate(
        [a.astype(f32).reshape(-1) for a in (sph, rct, box, light, env, mass)]
    )
    counts = dict(n_sph=ns, n_rct=nt, n_box=nb, n_light=nl, n_face=F,
                  n_mass=mass.shape[0])
    return table, counts


def _prim_blocks(table: np.ndarray, counts: dict) -> tuple:
    """The sphere, rect and box blocks of a :func:`scene_table`."""
    o1 = counts["n_sph"] * SPH_COLS
    o2 = o1 + counts["n_rct"] * RCT_COLS
    return table[:o1], table[o1:o2], table[o2:o2 + counts["n_box"] * BOX_COLS]


def walks_bvh(scn: SceneArrays, cfg: TraceConfig) -> bool:
    """Whether the kernel's launches of ``cfg`` on ``scn`` walk a BVH: the
    table :func:`tracer_table` gives them has a node block (found without
    building it)."""
    return uses_bvh(cfg) and bvh_fits(*_prim_blocks(*scene_table(scn.host_copy())))


def tracer_table(host: SceneArrays, cfg: TraceConfig) -> tuple[np.ndarray, dict]:
    """The kernel's table for ``cfg``: :func:`scene_table`, and for a
    configuration that walks the BVH (:func:`bendy_tpu_torch.ops.bvh.uses_bvh`)
    its node block appended after the mass block at a float4 boundary, so
    every earlier offset stays; the counts then also hold the block's offset
    ``bvh0`` and its ``n_node`` and ``n_key``. A table whose tree the
    kernel's uint16 walk cannot hold (``bvh_fits``) gets no node block: its
    launches run the sweep."""
    table, counts = scene_table(host)
    if not uses_bvh(cfg):
        return table, counts
    blocks = _prim_blocks(table, counts)
    if not bvh_fits(*blocks):
        return table, counts
    block = build_bvh(*blocks)
    bvh0 = -(-table.size // 4) * 4
    table = np.concatenate([table, np.zeros(bvh0 - table.size, np.float32), block])
    return table, dict(counts, bvh0=bvh0, **bvh_counts(block))


def _flags(cfg: TraceConfig) -> int:
    return ((FLAG_DIFFUSE if cfg.has_diffuse else 0)
            | (FLAG_METALLIC if cfg.has_metallic else 0)
            | (FLAG_GLASS if cfg.has_glass else 0)
            | (FLAG_DOF if cfg.has_dof else 0)
            | (FLAG_POLY if cfg.frustum_poly else 0)
            | (FLAG_GEO if cfg.geodesic else 0)
            | (FLAG_LOOPM if pools_items(cfg) else 0))


def pools_items(cfg: TraceConfig) -> bool:
    """Whether a launch of ``cfg`` runs the LOOPM instantiations (geodesics
    over looped masses), whose resident threads take their (lane, sample)
    items from a pool."""
    return cfg.geodesic and cfg.looped_masses


def per_item(cfg: TraceConfig, bvh: bool = False) -> bool:
    """Whether a launch of ``cfg`` (``bvh``: its table has a node block)
    traces each (lane, sample) item on its own into per-item buffers that
    :func:`fold_samples` adds in sample order: geodesics (the LOOPM
    instantiations with looped masses, the item instantiations with
    unrolled ones) and, without the BVH, media (the item instantiations).
    The surface and BVH instantiations keep one thread per lane (the
    kernel's PER_ITEM, the same rule)."""
    return cfg.geodesic or (cfg.has_volumes and not bvh)


def table_in_global(nbytes: int, bvh: bool = False) -> bool:
    """Whether a scene table of ``nbytes`` (node block included) stays in
    global memory (the GTAB instantiations) instead of being staged in
    shared memory, where a BVH launch also keeps its walk stacks."""
    return nbytes + (bvh_stack_bytes() if bvh else 0) > MAX_TABLE_BYTES


def staged_floats(lib, cfg: TraceConfig, table_floats: int, counts: dict) -> int:
    """The floats that a launch of ``cfg`` with a table of ``table_floats``
    and the ``counts`` of :func:`tracer_table` stages in shared memory
    unless its table stays in global memory, as the library ``lib`` counts
    them (``bendy_staged_floats``): the table and, for a launch without
    media or the BVH (surface or geodesic), the sweep rows that the kernel
    builds in front of it."""
    flags = _flags(cfg) | (FLAG_BVH if counts.get("bvh0", -1) >= 0 else 0)
    return lib.bendy_staged_floats(flags, int(cfg.has_volumes), table_floats,
                                   *(counts.get(k, 0) for k in ("n_sph", "n_rct", "n_box")))


def stays_in_global(lib, cfg: TraceConfig, table_floats: int, counts: dict) -> bool:
    """Whether that launch keeps its table in global memory (the GTAB
    instantiations): :func:`table_in_global` of what it would stage, beside
    the LOOPM threads' int each of static shared memory (their count of
    loop iterations, ``pool_trips``)."""
    from bendy_tpu_torch import _build

    trips = 4 * _build.TRACE_BLOCK if pools_items(cfg) else 0
    return table_in_global(4 * staged_floats(lib, cfg, table_floats, counts) + trips,
                           counts.get("bvh0", -1) >= 0)


def bvh_stack_bytes() -> int:
    """A BVH launch's walk stacks: uint16 node indices, ``BVH_STACK`` per
    thread of a block of the build's ``_build.TRACE_BLOCK`` threads, in
    shared memory after the staged table."""
    from bendy_tpu_torch import _build

    return 2 * BVH_STACK * _build.TRACE_BLOCK


def _check_launch(entry: str, dev: torch.device, rc: int, lib=None) -> None:
    """Raise on a refused launch (``rc``, the C entry's cudaGetLastError();
    ``lib``: the library launched from, default ``_build.library()``)."""
    from bendy_tpu_torch import _build

    if rc != 0:
        msg = (lib or _build.library()).bendy_cuda_error_string(rc).decode()
        raise RuntimeError(f"{entry} launch failed on {dev}: CUDA error {rc} ({msg})")


def _launch(entry: str, counter, table: torch.Tensor, counts: dict, cam_packed: torch.Tensor,
            pix: torch.Tensor, sub: torch.Tensor, width: int, height: int, spp: int,
            spp_total: int, subsample: int, key: tuple, sample0: int,
            cfg: TraceConfig, extra: tuple = (), outs: tuple | None = None,
            max_iters: int | None = None, bvh_tests: torch.Tensor | None = None,
            loop_use: torch.Tensor | None = None):
    """Check the arguments and launch the C entry point ``entry`` on the
    current stream; ``extra`` are the entry's arguments after
    ``loop_use``, where a tensor goes in as its pointer (None as NULL).
    ``loop_use`` ([2] int64), optional, gets the launch's warp use added by
    the tracer itself (the loop iterations of its threads and the
    iterations their warps issue; :func:`warp_use` is its plain version).
    ``outs`` (out, rays, iters) are the kernel's outputs (a per-item
    launch's per-item buffers), else allocated per lane; ``max_iters`` is
    the loop cap (default ``cfg.max_iters(spp)``). A table with a node
    block (``bvh0`` in ``counts``) launches the BVH instantiation, which
    writes each lane's node and primitive test counts to ``bvh_tests``
    ([2, B] int32) when it is given. While ``_build.phase_stubs`` holds a
    stub mask, the launch runs that mask's instantiation of the stub build.
    Each launch adds one to ``counter.launches`` (the calling wrapper's
    count). Returns (out, rays, iters)."""
    from bendy_tpu_torch import _build

    dev = pix.device
    B = pix.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"{entry} launches on CUDA tensors, got {dev}")
    for name, t, dtype in (("table", table, torch.float32),
                           ("cam_packed", cam_packed, torch.float32),
                           ("pix", pix, torch.int32), ("sub", sub, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if pix.shape != (B,) or sub.shape != (B,) or cam_packed.numel() < 18:
        raise ValueError("pix and sub must be [B]; cam_packed the [1,32] camera")
    if B >= 2**31:
        raise ValueError("lane count must fit int32")
    bvh0 = counts.get("bvh0", -1)
    if bvh_tests is not None and (bvh0 < 0 or bvh_tests.shape != (2, B) or bvh_tests.device != dev
                                  or bvh_tests.dtype != torch.int32
                                  or not bvh_tests.is_contiguous()):
        raise ValueError("bvh_tests: a contiguous [2, B] int32 tensor beside the lanes, for a "
                         "table with a node block")
    if loop_use is not None and (loop_use.shape != (2,) or loop_use.dtype != torch.int64
                                 or loop_use.device != dev or not loop_use.is_contiguous()):
        raise ValueError(f"loop_use: a contiguous [2] int64 tensor on {dev}")
    if outs is None:
        n_out = N_OUT if cfg.want_aovs else 3
        outs = (torch.empty((n_out, B), dtype=torch.float32, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev))
    out, rays, iters = outs
    if B == 0:
        return out, rays, iters
    lib, stub = _build.tracer()
    flags = (_flags(cfg) | (FLAG_GTAB if stays_in_global(lib, cfg, table.numel(), counts) else 0)
             | (FLAG_BVH if bvh0 >= 0 else 0) | stub)
    rc = getattr(lib, entry)(
        table.data_ptr(), table.numel(), cam_packed.data_ptr(), pix.data_ptr(),
        sub.data_ptr(), out.data_ptr(), rays.data_ptr(), iters.data_ptr(),
        B, width, height, spp, subsample, spp_total & 0xFFFFFFFF,
        key[0] & 0xFFFFFFFF, key[1] & 0xFFFFFFFF, sample0 & 0xFFFFFFFF,
        cfg.max_bounces, cfg.max_iters(spp) if max_iters is None else max_iters,
        cfg.clip_min, cfg.clip_max, flags, counts["n_sph"], counts["n_rct"],
        counts["n_box"], counts["n_light"], counts["n_face"], int(cfg.want_aovs), bvh0,
        None if bvh_tests is None else bvh_tests.data_ptr(),
        None if loop_use is None else loop_use.data_ptr(),
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in extra),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _check_launch(entry, dev, rc, lib)
    counter.launches += 1
    return out, rays, iters


def split_samples(lanes: int, spp: int, n_out: int) -> int:
    """Samples per chunk of a per-item launch: as many as keep its per-item
    buffers within ``SPLIT_BUDGET_BYTES`` and its items within
    ``MAX_ITEMS``, at least one (one sample's buffers are no larger than
    the lanes' own outputs). Raises where one sample of ``lanes`` lanes
    passes ``MAX_ITEMS``."""
    if lanes > MAX_ITEMS:
        raise ValueError(f"{lanes} lanes: a chunk of one sample passes the kernel's "
                         f"{MAX_ITEMS} int32 items")
    per_sample = max(lanes, 1) * 4 * (n_out + N_COUNTS)
    return max(1, min(spp, SPLIT_BUDGET_BYTES // per_sample, MAX_ITEMS // max(lanes, 1)))


_OVER_CAP: dict = {}  # device -> [1] int32 (over_cap_lanes)


def over_cap_lanes(device) -> torch.Tensor:
    """[1] int32 on ``device``: the lanes of every per-item launch there,
    since it was last zeroed (``.zero_()``), whose iteration sum passed the
    lane cap ``cfg.max_iters(spp)``. One thread per lane would have cut
    such a lane where the split traced every sample whole, so the two
    results differ there (csrc/trace_surface.cu, "The cap")."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _OVER_CAP:
        _OVER_CAP[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _OVER_CAP[dev]


def _traced(entry: str, counter, table, counts, cam_packed, pix, sub, width, height, spp,
            spp_total, subsample, key, sample0, cfg: TraceConfig, extra, vevents=None,
            near_steps=None, item_counts=None, bvh_tests=None, loop_use=None):
    """Launch ``entry``: one thread per lane, or for :func:`per_item` per
    (lane, sample) item into per-item buffers, each chunk of samples
    followed by its ordered fold (:func:`fold_samples`) into the per-lane
    outputs. ``extra(near_steps, vevents)`` gives the entry's arguments
    after ``loop_use``. ``item_counts``, optional
    [N_COUNTS, B, spp] int32, receives a per-item launch's per-item counts
    (row 2, vevents, only with volumes; row 3, RK4 steps, only with
    geodesics). ``bvh_tests``, ``loop_use`` (every launch's) and
    ``counter`` as for :func:`_launch`. Returns (out, rays, iters)."""
    if not per_item(cfg, "bvh0" in counts):
        return _launch(entry, counter, table, counts, cam_packed, pix, sub, width, height, spp,
                       spp_total, subsample, key, sample0, cfg,
                       extra=extra(near_steps, vevents), bvh_tests=bvh_tests, loop_use=loop_use)
    dev, B = pix.device, pix.shape[0]
    if spp < 1:
        raise ValueError(f"a per-item launch traces at least one sample, got spp {spp}")
    n_out = N_OUT if cfg.want_aovs else 3
    out = torch.empty((n_out, B), dtype=torch.float32, device=dev)
    rays = torch.empty(B, dtype=torch.int32, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    if item_counts is not None and (item_counts.shape != (N_COUNTS, B, spp)
                                    or item_counts.dtype != torch.int32
                                    or item_counts.device != dev):
        raise ValueError(f"item_counts: a [{N_COUNTS}, B, spp] int32 tensor beside the lanes")
    sc = split_samples(B, spp, n_out)
    samp = torch.empty(n_out * B * sc, dtype=torch.float32, device=dev)
    cnt = torch.empty(N_COUNTS * B * sc, dtype=torch.int32, device=dev)
    cap = cfg.max_iters(spp)  # the whole lane's cap for every item
    for c0 in range(0, spp, sc):
        s = min(sc, spp - c0)
        f = samp[:n_out * B * s].view(n_out, B * s)
        c = cnt[:N_COUNTS * B * s].view(N_COUNTS, B * s)
        _launch(entry, counter, table, counts, cam_packed, pix, sub, width, height, s, spp_total,
                subsample, key, sample0 + c0, cfg, extra=extra(c[3], c[2]),
                outs=(f, c[0], c[1]), max_iters=cap, loop_use=loop_use)
        fold_samples(f, c, s, out, rays, iters, vevents, near_steps, first=c0 == 0,
                     max_iters=cap if c0 + s == spp else -1, over_cap=over_cap_lanes(dev))
        if item_counts is not None:
            item_counts[:, :, c0:c0 + s] = c.view(N_COUNTS, B, s)
    return out, rays, iters


def item_occupancy(cfg: TraceConfig, table_floats: int,
                   counts: dict | None = None) -> tuple[int, int, int]:
    """(blocks per SM its register budget asks for, 0 for none, blocks one
    SM holds, SMs) of the instantiation without the BVH that a launch of
    ``cfg`` with a table of ``table_floats`` and the primitive ``counts`` of
    :func:`scene_table` (default none) runs on the current card: the item
    instantiation of geodesics or media, the LOOPM one with looped masses
    (whose resident grid is that many blocks on every SM), or the surface
    one, one thread per lane; blocks of the build's ``_build.TRACE_BLOCK``
    threads (the last two give the warps per SM)."""
    from bendy_tpu_torch import _build

    lib = _build.library()
    out = (ctypes.c_int * 3)()
    counts = counts or {}
    flags = _flags(cfg) | (FLAG_GTAB if stays_in_global(lib, cfg, table_floats, counts) else 0)
    rc = lib.bendy_item_occupancy(flags, int(cfg.has_volumes), int(cfg.want_aovs), table_floats,
                                  *(counts.get(k, 0) for k in ("n_sph", "n_rct", "n_box")),
                                  ctypes.addressof(out))
    _check_launch("bendy_item_occupancy", torch.device("cuda"), rc)
    return tuple(out)


def warp_use(iters: torch.Tensor) -> torch.Tensor:
    """[2] int64: the loop iterations of a launch's threads, ``iters`` in
    launch order, summed, and the iterations their warps of 32 consecutive
    threads issue, 32 × each warp's longest; a trailing partial warp is left
    out of both. The one host count of issued iterations, as the tracer
    counts them (``count_warp_use`` in ``csrc/trace_surface.cu``)."""
    its = iters.reshape(-1)
    w = its[:its.numel() // 32 * 32].reshape(-1, 32).to(torch.int64)
    return torch.stack([w.sum(), 32 * w.amax(dim=1).sum()])


def warp_use_plain(iters: torch.Tensor, loop_use: torch.Tensor) -> None:
    """Plain version of the tracer's warp-use count where each thread
    traces one lane or one item: adds :func:`warp_use` of ``iters`` to
    ``loop_use`` ([2] int64)."""
    loop_use += warp_use(iters)


def warp_use_pool_plain(iters: torch.Tensor, loop_use: torch.Tensor, threads: int) -> None:
    """Plain model of the LOOPM tracer's own warp-use count: ``iters``, the
    loop iterations of a launch's items in item order, traced by ``threads``
    threads (the resident grid) that each start on item = its index and,
    when their item's iterations run out, take the next unclaimed index
    (the earliest free thread first, ties in thread order, every thread at
    one iteration a step). Adds to ``loop_use`` ([2] int64) the
    :func:`warp_use` of the threads' loop trips (each its items' iterations
    summed). Items of equal length issue what :func:`warp_use_plain` counts
    for one item a thread; the kernel's warps drift apart, so its count is
    the measure."""
    its = iters.reshape(-1).to(torch.int64)
    n = its.numel()
    t = min(threads, n)
    free = its[:t].clone()  # when each thread's item runs out: its loop trips
    k = t  # the next unclaimed item
    while k < n:
        idx = (free == free.min()).nonzero().flatten()[:n - k]  # in thread order
        x = its[k:k + idx.numel()]
        free[idx] += x
        k += idx.numel()
    loop_use += warp_use(free)


def fold_samples_plain(samp: torch.Tensor, cnt: torch.Tensor, spp: int, out: torch.Tensor,
                       rays: torch.Tensor, iters: torch.Tensor,
                       vevents: torch.Tensor | None = None,
                       near_steps: torch.Tensor | None = None, *, first: bool = True,
                       max_iters: int = -1, over_cap: torch.Tensor | None = None) -> None:
    """Plain version of :func:`fold_samples`: per lane, the per-item words
    added in sample order from 0 (or from the outputs' values when not
    ``first``), in place."""
    n_out, B = out.shape
    f = samp.view(n_out, B, spp)
    c = cnt.view(N_COUNTS, B, spp)
    acc = torch.zeros_like(out) if first else out.clone()
    for s in range(spp):
        acc = acc + f[:, :, s]
    out.copy_(acc)
    for row, dst in enumerate((rays, iters, vevents, near_steps)):
        if dst is None:
            continue
        tot = torch.zeros_like(dst) if first else dst.clone()
        for s in range(spp):
            tot = tot + c[row, :, s]
        dst.copy_(tot)
    if max_iters >= 0:
        over_cap += (iters > max_iters).sum(dtype=torch.int32)


def fold_samples(samp: torch.Tensor, cnt: torch.Tensor, spp: int, out: torch.Tensor,
                 rays: torch.Tensor, iters: torch.Tensor, vevents: torch.Tensor | None = None,
                 near_steps: torch.Tensor | None = None, *, first: bool = True,
                 max_iters: int = -1, over_cap: torch.Tensor | None = None) -> None:
    """The ordered fold of a looped-mass launch (``fold_kernel`` of
    ``csrc/trace_surface.cu``), in place on the current stream: ``samp``
    [n_out, B·spp] f32 and ``cnt`` [N_COUNTS, B·spp] int32 per item (item =
    lane·spp + s) into ``out`` [n_out, B] and the [B] int32 ``rays``,
    ``iters``, ``vevents`` and ``near_steps`` (the last two optional).
    Each lane's words are added in sample order from 0, or from the
    outputs' values when not ``first`` (the next chunk of samples), so the
    sums are bit-equal to one thread tracing the lane's samples in turn.
    With ``max_iters >= 0`` the lanes whose iteration sum passes it are
    added to ``over_cap`` ([1] int32). CPU tensors run
    :func:`fold_samples_plain`; CUDA ones launch the kernel (adding one to
    ``fold_samples.launches``) or raise."""
    from bendy_tpu_torch import _build

    dev = out.device
    n_out, B = out.shape
    if max_iters >= 0 and over_cap is None:
        raise ValueError("fold_samples: max_iters needs an over_cap counter")
    ints = [t for t in (rays, iters, vevents, near_steps, over_cap) if t is not None]
    if (samp.shape != (n_out, B * spp) or cnt.shape != (N_COUNTS, B * spp)
            or samp.dtype != torch.float32 or out.dtype != torch.float32
            or any(t.dtype != torch.int32 for t in (cnt, *ints))
            or any(t.shape != (B,) for t in (rays, iters, vevents, near_steps) if t is not None)
            or any(t.device != dev or not t.is_contiguous() for t in (samp, cnt, out, *ints))):
        raise ValueError(f"fold_samples: expected contiguous samp [n_out, B·spp] f32, cnt "
                         f"[{N_COUNTS}, B·spp] int32, out [n_out, B] f32 and [B] int32 counts "
                         f"on {dev}")
    if dev.type == "cpu":
        return fold_samples_plain(samp, cnt, spp, out, rays, iters, vevents, near_steps,
                                  first=first, max_iters=max_iters, over_cap=over_cap)
    if dev.type != "cuda":
        raise ValueError(f"fold_samples runs on CPU or CUDA tensors, got {dev}")
    if B == 0:
        return None
    ptr = [None if t is None else t.data_ptr() for t in (vevents, near_steps, over_cap)]
    rc = _build.library().bendy_fold_samples(
        samp.data_ptr(), cnt.data_ptr(), B, spp, n_out, int(first), max_iters, out.data_ptr(),
        rays.data_ptr(), iters.data_ptr(), *ptr, torch.cuda.current_stream(dev).cuda_stream)
    _check_launch("bendy_fold_samples", dev, rc)
    fold_samples.launches += 1
    return None


fold_samples.launches = 0


def trace_surface(table: torch.Tensor, counts: dict, cam_packed: torch.Tensor,
                  pix: torch.Tensor, sub: torch.Tensor, *, width: int,
                  height: int, spp: int, spp_total: int, subsample: int,
                  key: tuple, sample0: int, cfg: TraceConfig,
                  bvh_tests: torch.Tensor | None = None,
                  loop_use: torch.Tensor | None = None):
    """Launch the flat surface instantiation of ``csrc/trace_surface.cu``
    on the current stream; the BVH one for a table of :func:`tracer_table`
    with a node block, whose per-lane node and primitive test counts go to
    ``bvh_tests`` ([2, B] int32) when it is given. ``loop_use`` as for
    :func:`_launch`.

    Returns (out [3 or 10, B] f32 channel sums, rays [B] int32, iters
    [B] int32). Adds one to ``trace_surface.launches`` per launch. Raises
    on anything the kernel does not take and on a refused launch.
    """
    if cfg.geodesic or cfg.has_volumes:
        raise ValueError("a geodesic configuration launches trace_geodesic, one with "
                         "volumes trace_volume")
    return _launch("bendy_trace_surface", trace_surface, table, counts, cam_packed, pix, sub,
                   width, height, spp, spp_total, subsample, key, sample0, cfg,
                   bvh_tests=bvh_tests, loop_use=loop_use)


trace_surface.launches = 0


def trace_geodesic(table: torch.Tensor, counts: dict, cam_packed: torch.Tensor,
                   pix: torch.Tensor, sub: torch.Tensor, *, width: int,
                   height: int, spp: int, spp_total: int, subsample: int,
                   key: tuple, sample0: int, cfg: TraceConfig,
                   near_steps: torch.Tensor | None = None,
                   item_counts: torch.Tensor | None = None,
                   loop_use: torch.Tensor | None = None):
    """Launch the geodesic instantiation of ``csrc/trace_surface.cu`` (RK4
    chord stepping; the item instantiation over unrolled masses, or the
    LOOPM one with ``cfg.looped_masses``) on the current stream.

    Same outputs as :func:`trace_surface`; the ``GeoParams`` go in as
    launch arguments. The kernel traces each (lane, sample) on its own and
    the fold kernel adds each lane's samples in order (:func:`fold_samples`,
    chunks of :func:`split_samples`), with the same sums as one thread per
    lane; ``near_steps`` (an optional [B] int32 output) receives each
    lane's count of RK4 steps, ``item_counts`` and ``loop_use`` those of
    :func:`_traced`. Adds one to ``trace_geodesic.launches`` per kernel launch (one per
    chunk of samples). Raises unless
    ``cfg.geodesic`` without volumes and 1 <= n_mass (at most
    ``MAX_MASSES`` unless ``cfg.looped_masses``).
    """
    if cfg.has_volumes:
        raise ValueError("a configuration with volumes launches trace_volume")
    geo = _geo_args(counts, cfg)
    return _traced("bendy_trace_geodesic", trace_geodesic, table, counts, cam_packed, pix, sub,
                   width, height, spp, spp_total, subsample, key, sample0, cfg,
                   lambda near, vev: (*geo, near),
                   near_steps=_near_steps(near_steps, pix, cfg), item_counts=item_counts,
                   loop_use=loop_use)


trace_geodesic.launches = 0


def _geo_args(counts: dict, cfg: TraceConfig) -> tuple:
    """(n_mass, GeoParams...) launch arguments of a geodesic configuration:
    1 to ``MAX_MASSES`` unrolled masses, or with ``cfg.looped_masses`` any
    count from 1."""
    n_mass = counts["n_mass"]
    if not cfg.geodesic or n_mass < 1 or (n_mass > MAX_MASSES and not cfg.looped_masses):
        raise ValueError(f"a geodesic launch takes 1 to {MAX_MASSES} unrolled masses or "
                         f"at least 1 looped, got geodesic={cfg.geodesic}, "
                         f"looped_masses={cfg.looped_masses}, {n_mass} masses")
    geo = cfg.geo or GeoParams()
    return (n_mass, geo.eta, geo.min_step, geo.max_step, geo.far, geo.max_steps, geo.growth)


def _near_steps(near_steps: torch.Tensor | None, pix: torch.Tensor, cfg: TraceConfig):
    """The optional per-lane RK4-step output of a geodesic launch (every
    geodesic launch runs per item: :func:`per_item`)."""
    if near_steps is None:
        return None
    if (not cfg.geodesic or near_steps.shape != pix.shape
            or near_steps.dtype != torch.int32 or near_steps.device != pix.device):
        raise ValueError("near_steps: a [B] int32 tensor beside the lanes, for a geodesic launch")
    return near_steps


def trace_volume(table: torch.Tensor, counts: dict, cam_packed: torch.Tensor,
                 pix: torch.Tensor, sub: torch.Tensor, grid: torch.Tensor, *, width: int,
                 height: int, spp: int, spp_total: int, subsample: int,
                 key: tuple, sample0: int, cfg: TraceConfig,
                 near_steps: torch.Tensor | None = None,
                 item_counts: torch.Tensor | None = None,
                 bvh_tests: torch.Tensor | None = None,
                 loop_use: torch.Tensor | None = None):
    """Launch the volume instantiation of ``csrc/trace_surface.cu`` (march
    mode and the 8-corner density lookup of ``grid``, the ``[G, D, H, W]``
    f32 stack of the scene's density grids; geodesic inside media when
    ``cfg.geodesic``) on the current stream.

    Returns (out, rays, iters) as :func:`trace_surface`, then vol_events
    [B] int32, each lane's count of volume events (density lookups). It
    runs per item as :func:`trace_geodesic` does (the item instantiation,
    or the LOOPM one with looped masses), ``near_steps``,
    ``item_counts`` and ``loop_use`` as there; with the BVH (a table with a node block) one
    thread per lane, ``bvh_tests`` as for :func:`trace_surface`. Adds one to
    ``trace_volume.launches`` per kernel launch (one per chunk of samples).
    Raises unless
    ``cfg.has_volumes``, on a grid the kernel does not take, and as
    :func:`trace_geodesic` on a geodesic configuration it does not take.
    """
    if not cfg.has_volumes:
        raise ValueError("trace_volume takes a configuration with volumes")
    if (grid.dim() != 4 or grid.dtype != torch.float32 or not grid.is_contiguous()
            or grid.device != pix.device or min(grid.shape) < 1):
        raise ValueError(f"grid: expected a contiguous [G,D,H,W] float32 tensor on "
                         f"{pix.device}, got {tuple(grid.shape)} {grid.dtype} on {grid.device}")
    geo = _geo_args(counts, cfg) if cfg.geodesic else (0, 0.0, 0.0, 0.0, 0.0, 0, 0.0)
    vevents = torch.empty(pix.shape[0], dtype=torch.int32, device=pix.device)
    G, D, H, W = grid.shape
    out, rays, iters = _traced(
        "bendy_trace_volume", trace_volume, table, counts, cam_packed, pix, sub, width, height,
        spp, spp_total, subsample, key, sample0, cfg,
        lambda near, vev: (*geo, near, grid, G, D, H, W, cfg.volume_step,
                           cfg.max_volume_bounces, int(cfg.vol_nearest), vev),
        vevents=vevents, near_steps=_near_steps(near_steps, pix, cfg), item_counts=item_counts,
        bvh_tests=bvh_tests, loop_use=loop_use)
    return out, rays, iters, vevents


trace_volume.launches = 0


def make_tracer(scn: SceneArrays, width: int, height: int, spp: int,
                subsample: int, cfg: TraceConfig, spp_total: int | None = None):
    """Build the tracer for one compiled scene.

    Returns ``fn(cam_packed [1,32] f32, seed, pass_idx, pix [B], sub [B],
    sample0=0, count_tests=False, count_steps=False, count_items=False) ->
    TraceSums``: on
    CUDA lane tensors the
    kernel (:func:`trace_volume` for a configuration with volumes, else
    :func:`trace_geodesic` for a geodesic one, else :func:`trace_surface`),
    on CPU ones the plain :func:`trace_core`. Each lane traces the samples
    [sample0, sample0+spp) of a global ``spp_total`` (default ``spp``), so
    the sharded pass splits samples over ranks with globally unique RNG
    streams. Ray, iteration and volume-event counts are int64 sums of
    per-lane counts, with the same meaning on both routes, and
    ``lane_counts`` holds the per-lane counts themselves (``near_steps``,
    each lane's RK4 steps, on the kernel route only when ``count_steps``
    asks for them with geodesics; the CPU route always counts them). The
    looped-sweep
    scenes (``cfg.looped_sweep``) without geodesics walk a BVH built once,
    at the first call on a card (:func:`tracer_table`); ``count_tests``
    then adds each lane's node and primitive tests to ``lane_counts``
    (``node_tests``, ``prim_tests``). The CPU route sweeps every primitive,
    the image the walk is held to, and builds no table. ``count_items``
    adds, on a kernel launch that runs per (lane, sample) item
    (:func:`per_item`), each item's rays and iterations (``item_rays``,
    ``item_iters``: [B, spp] int32, the counts of the launch's threads).

    ``fn.words(cam_packed, seed, pass_idx, pix, sub, sample0=0,
    loop_use=None)`` traces the same lanes and returns only the per-lane
    words a render pass accumulates (:func:`accumulate`): the channel sums
    [3 or 10, B] f32 and each lane's traced rays [B] (int32 from the kernel,
    int64 from the plain version), with none of the reductions of
    ``TraceSums``. With ``loop_use`` ([2] int64) the tracer's warp use is
    added to it: by every kernel launch itself (:func:`_launch`), and on the
    CPU route, whose loop is per lane, by :func:`warp_use_plain` of the
    lanes' iterations.
    """
    spp_total = spp if spp_total is None else spp_total
    check_trace_args(width, height, spp_total, subsample, cfg)
    host_table = functools.cache(lambda: tracer_table(scn.host_copy(), cfg))
    tables: dict = {}
    grids: dict = {}

    def launch(cam_packed, seed, pass_idx, pix, sub, sample0, count_tests=False,
               count_steps=False, count_items=False, loop_use=None):
        """The kernel route: (out, rays, iters, vol_events or None, bvh
        tests or None, RK4 steps or None, item counts or None), per lane;
        ``loop_use`` goes to every launch."""
        dev = pix.device
        if dev not in tables:
            with telemetry.one_off("pass.build"):
                table_np, counts = host_table()
                tables[dev] = (torch.from_numpy(table_np).to(dev), counts)
        table, counts = tables[dev]
        if count_tests and "bvh0" not in counts:
            raise ValueError("count_tests: only the kernel's BVH walk counts its tests")
        kw = dict(width=width, height=height, spp=spp, spp_total=spp_total,
                  subsample=subsample, key=render_key(seed, pass_idx), sample0=sample0,
                  cfg=cfg, loop_use=loop_use)
        tests = near = items = None
        if count_items and per_item(cfg, "bvh0" in counts):
            items = kw["item_counts"] = torch.empty((N_COUNTS, pix.shape[0], spp),
                                                    dtype=torch.int32, device=dev)
        if count_tests:
            tests = kw["bvh_tests"] = torch.empty((2, pix.shape[0]), dtype=torch.int32,
                                                  device=dev)
        if count_steps:
            near = kw["near_steps"] = torch.empty(pix.shape[0], dtype=torch.int32, device=dev)
        lanes = (table, counts, cam_packed.reshape(-1), pix.to(torch.int32),
                 sub.to(torch.int32))
        if cfg.has_volumes:
            if dev not in grids:
                grids[dev] = scn.vol_grid.to(dev).contiguous()
            return (*trace_volume(*lanes, grids[dev], **kw), tests, near, items)
        launch_fn = trace_geodesic if cfg.geodesic else trace_surface
        return (*launch_fn(*lanes, **kw), None, tests, near, items)

    def plain(cam_packed, seed, pass_idx, pix, sub, sample0):
        return trace_core(scn, unpack_camera(cam_packed), render_key(seed, pass_idx), pix, sub,
                          width, height, spp, subsample, cfg, spp_total=spp_total,
                          sample0=sample0)

    def run(cam_packed, seed, pass_idx, pix, sub, sample0: int = 0,
            count_tests: bool = False, count_steps: bool = False,
            count_items: bool = False) -> TraceSums:
        dev = pix.device
        if count_tests and dev.type != "cuda":
            raise ValueError("count_tests: only the kernel's BVH walk counts its tests")
        if count_items and dev.type != "cuda":
            raise ValueError("count_items: only the kernel's launches trace per item")
        if count_steps and not cfg.geodesic:
            raise ValueError("count_steps: only a geodesic trace takes RK4 steps")
        if dev.type == "cpu":
            return plain(cam_packed, seed, pass_idx, pix, sub, sample0)
        if dev.type != "cuda":
            raise ValueError(f"no tracer for device {dev}")
        out, rays, iters, vol, tests, near, items = launch(
            cam_packed, seed, pass_idx, pix, sub, sample0, count_tests, count_steps, count_items)
        vol = torch.zeros_like(rays) if vol is None else vol
        lane_counts = dict(rays=rays, iters=iters, vol_events=vol)
        if tests is not None:
            lane_counts.update(node_tests=tests[0], prim_tests=tests[1])
        if near is not None:
            lane_counts["near_steps"] = near
        if items is not None:
            lane_counts.update(item_rays=items[0], item_iters=items[1])
        sums = (rays.sum(dtype=torch.int64), iters.sum(dtype=torch.int64),
                vol.sum(dtype=torch.int64))
        rad = V3(out[0], out[1], out[2])
        if not cfg.want_aovs:
            return TraceSums(rad, rad, rad, rad.x, *sums, lane_counts=lane_counts)
        return TraceSums(rad, V3(out[3], out[4], out[5]), V3(out[6], out[7], out[8]),
                         out[9], *sums, lane_counts=lane_counts)

    def words(cam_packed, seed, pass_idx, pix, sub, sample0: int = 0, loop_use=None):
        dev = pix.device
        if dev.type == "cpu":
            res = plain(cam_packed, seed, pass_idx, pix, sub, sample0)
            chans = [*res.radiance]
            if cfg.want_aovs:
                chans += [*res.aov_albedo, *res.aov_normal, res.aov_depth]
            if loop_use is not None:
                warp_use_plain(res.lane_counts["iters"], loop_use)
            return torch.stack(chans), res.lane_counts["rays"]
        if dev.type != "cuda":
            raise ValueError(f"no tracer for device {dev}")
        return launch(cam_packed, seed, pass_idx, pix, sub, sample0, loop_use=loop_use)[:2]

    run.words = words
    return run


def tile_perm(width: int, rows: int, nn: int, lanes_per_block: int):
    """Tile-major pixel order for blocks whose lanes end alike (the
    reference's ``tile_perm``, ``bendy_tpu/ops/pallas_trace.py:279``, the
    same permutation and tiling for the same arguments).

    A block runs until its slowest lane is done, and in row-major order a
    block spans a strip of a row; path lengths vary smoothly over the
    image, so a square-ish tile of ``lanes_per_block // nn`` pixels is more
    alike than a strip. Full tile-rows over the full tile-columns come
    first; a ragged right edge (``width`` not a multiple of the tile width)
    and trailing rows that do not fill a tile-row stay row-major after them.

    Returns ``(perm, (tile_w, tile_h, rows_full, cols_full))`` over the
    chunk's ``rows*width`` pixels (numpy int64), or ``(None, None)`` where
    tiling would not change the order (a block holds less than a pixel's
    ``nn`` lanes, or a tile as wide as the image)."""
    pix_per_block = lanes_per_block // max(nn, 1)
    if pix_per_block <= 0:
        return None, None
    tile_w = 1 << max(0, int(round(np.log2(max(1.0, np.sqrt(pix_per_block))))))
    tile_w = min(tile_w, width)
    tile_h = max(1, pix_per_block // tile_w)
    rows_full = (rows // tile_h) * tile_h
    cols_full = (width // tile_w) * tile_w
    if tile_w >= width or tile_h <= 1 or rows_full == 0:
        return None, None
    full = np.arange(rows * width).reshape(rows, width)
    head = full[:rows_full, :cols_full].reshape(
        rows_full // tile_h, tile_h, cols_full // tile_w, tile_w
    ).transpose(0, 2, 1, 3).ravel()
    edge = full[:rows_full, cols_full:].ravel()  # ragged right edge
    tail = full[rows_full:, :].ravel()  # ragged trailing rows
    return np.concatenate([head, edge, tail]), (tile_w, tile_h, rows_full, cols_full)


def lanes_per_block(cfg: TraceConfig, bvh: bool, lanes: int, spp: int) -> int:
    """The lanes one block of a launch of ``cfg`` over ``lanes`` lanes at
    ``spp`` holds (``bvh``: its table has a node block), the
    ``lanes_per_block`` of :func:`tile_perm`: on the lane-loop
    instantiations (surface, BVH) the build's threads per block
    (``_build.TRACE_BLOCK``); on the per-item and LOOPM ones
    (:func:`per_item`) the threads per block over the samples a launch
    traces per lane (:func:`split_samples`). At 128 threads that is 2 lanes
    at 64 spp (cloud, dense_cloud: fewer than a pixel's 4 subpixels, so
    :func:`tile_perm` declines and the lanes stay row-major), 4 at 32 spp
    and 8 at 16 spp with one subpixel (blackhole, blackhole_cloud,
    mass_cluster: tiles of 2 x 2 and 4 x 2 pixels)."""
    from bendy_tpu_torch import _build

    if not per_item(cfg, bvh):
        return _build.TRACE_BLOCK
    return _build.TRACE_BLOCK // split_samples(lanes, spp, N_OUT if cfg.want_aovs else 3)


def pass_lanes(width: int, rows: int, nn: int, y_offset: int, device, tile: bool = False,
               lanes_per_block: int | None = None):
    """(pix, sub) int32 lanes of image rows [y_offset, y_offset+rows):
    (pixel, subpixel) with global pixel ids, each pixel's ``nn`` subpixels
    contiguous and in order, so any row chunking and either order renders
    the same image. Row-major, or with ``tile`` in the tile-major order of
    :func:`tile_perm` for ``lanes_per_block`` (the launch's, as
    :func:`lanes_per_block` gives it) where that does not decline."""
    perm = None
    if tile:
        if lanes_per_block is None:
            raise ValueError("tile: the tile-major order needs the launch's lanes_per_block")
        perm, _ = tile_perm(width, rows, nn, lanes_per_block)
    if perm is None:
        local = torch.arange(rows * width * nn, dtype=torch.int32, device=device)
        return y_offset * width + local // nn, local % nn
    pix = np.repeat(perm + y_offset * width, nn).astype(np.int32)
    sub = np.tile(np.arange(nn, dtype=np.int32), rows * width)
    return torch.from_numpy(pix).to(device), torch.from_numpy(sub).to(device)


def render_lanes(scn: SceneArrays, cfg: TraceConfig, width: int, rows: int, spp: int, nn: int,
                 y_offset: int, device, tile: bool):
    """(pix, sub, tiled) of a render pass of ``cfg`` over image rows
    [y_offset, y_offset+rows): :func:`pass_lanes`, tile-major with
    ``tile`` at the lanes per block of the launch (:func:`lanes_per_block`),
    and whether the order is tile-major (else row-major)."""
    per_block = lanes_per_block(cfg, walks_bvh(scn, cfg), rows * width * nn, spp) if tile else 0
    pix, sub = pass_lanes(width, rows, nn, y_offset, device, tile, per_block)
    return pix, sub, tile and tile_perm(width, rows, nn, per_block)[0] is not None


def pixel_sums(res: TraceSums, output: str, rows: int, width: int, nn: int) -> torch.Tensor:
    """Per-lane sums of the requested channel -> per-pixel sums [rows,W,3]
    (``torch.sum`` over the subpixels, in no promised order): the plain
    passes' route and the yardstick of :func:`accumulate`."""
    if output == "full":
        ch = res.radiance
    elif output == "albedo":
        ch = res.aov_albedo
    elif output == "normal":
        ch = res.aov_normal
    elif output == "depth":
        d = res.aov_depth  # already normalized+clamped per sample
        ch = V3(d, d, d)
    else:
        raise ValueError(f"unknown output {output!r}")
    return torch.stack([c.reshape(rows, width, nn).sum(dim=2) for c in ch], dim=-1)


# each output's rows of the tracer's channel sums: the first and the step
# to the next film channel (depth, one row, fills all three)
CHANNEL_ROWS = {"full": (0, 1), "albedo": (3, 1), "normal": (6, 1), "depth": (9, 0)}


def _channel_rows(output: str, n_out: int) -> tuple[int, int]:
    if output not in CHANNEL_ROWS:
        raise ValueError(f"unknown output {output!r}")
    row0, step = CHANNEL_ROWS[output]
    if row0 + 2 * step >= n_out:
        raise ValueError(f"output {output!r} reads row {row0 + 2 * step} of channel sums with "
                         f"{n_out} rows")
    return row0, step


def accumulate_plain(out: torch.Tensor, rays: torch.Tensor, output: str, nn: int,
                     dst: torch.Tensor, *, add: bool, ray_total: torch.Tensor,
                     pix: torch.Tensor | None = None, pix0: int = 0) -> None:
    """Plain version of :func:`accumulate`, with its subpixel order; tiled
    lanes (``pix``) go to their film rows by ``index_add_`` or
    ``index_copy_``."""
    row0, step = _channel_rows(output, out.shape[0])
    words = out[[row0, row0 + step, row0 + 2 * step]].view(3, -1, nn)
    acc = words[:, :, 0]
    for s in range(1, nn):
        acc = acc + words[:, :, s]
    if pix is not None:
        film, slots = dst.view(-1, 3), pix[::nn].long() - pix0
        if add:
            film.index_add_(0, slots, acc.t())
        else:
            film.index_copy_(0, slots, acc.t())
    elif add:
        dst += acc.t().reshape(dst.shape)
    else:
        dst.copy_(acc.t().reshape(dst.shape))
    ray_total += rays.sum(dtype=torch.int64)


def accumulate(out: torch.Tensor, rays: torch.Tensor, output: str, nn: int, dst: torch.Tensor,
               *, add: bool, ray_total: torch.Tensor, pix: torch.Tensor | None = None,
               pix0: int = 0) -> None:
    """A render pass's subpixel sum, film add and ray count
    (``csrc/accumulate.cu``), in place on the current stream.

    ``out`` [n_out, B] f32 are the tracer's per-lane channel sums and
    ``rays`` [B] its per-lane ray counts, B = P·``nn`` lanes in row-major
    (pixel, subpixel) order (:func:`pass_lanes`), or, given the lanes'
    pixel ids ``pix`` ([B] int32, each pixel's subpixels contiguous and in
    order, as the tile-major order keeps them), the pixel of lane
    p·``nn`` going to film row ``pix[p·nn] - pix0``. For each of the P pixels
    the three film channels of ``output`` (:data:`CHANNEL_ROWS`) are the sums
    of its ``nn`` subpixel words in subpixel order, ((s0 + s1) + s2) + ...,
    added to ``dst`` (the pixels' [..., 3] f32 film rows, contiguous) with
    ``add``, else stored there; the lanes' rays are added to ``ray_total``
    ([1] int64), exactly. At ``nn = 1`` the film equals ``dst +
    pixel_sums(...)`` bit for bit; past it ``torch.sum``'s order may differ
    by rounding. CPU tensors run :func:`accumulate_plain`; CUDA ones launch
    the kernel (adding one to ``accumulate.launches``) or raise."""
    from bendy_tpu_torch import _build

    dev = out.device
    pixels = dst.numel() // 3
    if (out.dim() != 2 or out.dtype != torch.float32 or dst.dtype != torch.float32
            or dst.shape[-1:] != (3,) or out.shape[1] != pixels * nn or nn < 1
            or rays.shape != (out.shape[1],) or ray_total.shape != (1,)
            or ray_total.dtype != torch.int64 or rays.is_floating_point()
            or (pix is not None and (pix.shape != rays.shape or pix.dtype != torch.int32))
            or any(t.device != dev or not t.is_contiguous()
                   for t in (out, rays, dst, ray_total) + ((pix,) if pix is not None else ()))):
        raise ValueError(f"accumulate: expected contiguous out [n_out, P·nn] f32, rays [P·nn] "
                         f"integers, dst [..., 3] f32 of P pixels, ray_total [1] int64 and "
                         f"optional pix [P·nn] int32 on {dev}")
    row0, step = _channel_rows(output, out.shape[0])
    if dev.type == "cpu":
        return accumulate_plain(out, rays, output, nn, dst, add=add, ray_total=ray_total,
                                pix=pix, pix0=pix0)
    if dev.type != "cuda":
        raise ValueError(f"accumulate runs on CPU or CUDA tensors, got {dev}")
    if rays.dtype != torch.int32:
        raise ValueError(f"accumulate: the kernel takes int32 rays, got {rays.dtype}")
    if pixels == 0:
        return None
    rc = _build.library().bendy_accumulate(
        out.data_ptr(), out.shape[0], out.shape[1], row0, step, rays.data_ptr(), pixels, nn,
        None if pix is None else pix.data_ptr(), pix0, dst.data_ptr(), int(add),
        ray_total.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _check_launch("bendy_accumulate", dev, rc)
    accumulate.launches += 1
    return None


accumulate.launches = 0


def make_render_pass(scn: SceneArrays, width: int, height: int, rows: int,
                     spp: int, subsample: int, cfg: TraceConfig, output: str,
                     tile: bool = TILE):
    """Counterpart of ``render.render_pass`` on the tracer (the reference's
    ``make_pallas_render_pass``): returns ``fn(cam_packed, seed, pass_idx,
    y_offset, dst=None, add=False, rays=None, loop_use=None) -> (dst, rays)`` over image
    rows [y_offset, y_offset+rows), on ``cam_packed``'s device: one tracer
    call (:func:`make_tracer`'s ``words``), then one :func:`accumulate` of
    its pixel sums into ``dst`` ([rows, W, 3] f32; allocated when None),
    added to it with ``add`` (a film's rows) else stored, and of its rays
    into ``rays`` ([1] int64; zeros allocated when None). With ``tile`` the
    lanes go in tile-major order (:func:`render_lanes`), which renders the
    same film bit for bit. With ``loop_use`` ([2] int64) the pass adds the
    tracer's warp use to it: the loop iterations of the tracer's threads
    and the iterations their warps issue, counted by the tracer itself (no
    launch is added).
    The lanes of each (y_offset, device) are built at
    its first pass and kept (8 bytes a lane), so a pass runs no torch op
    besides the tracer's and the accumulate's allocations;
    ``fn.lanes(y_offset, device)`` gives them as (pix, sub).
    """
    nn = max(subsample, 1) ** 2
    tracer = make_tracer(scn, width, height, spp, subsample, cfg)
    lanes: dict = {}

    def lanes_of(y_offset: int, dev: torch.device):
        if (y_offset, dev) not in lanes:
            with telemetry.one_off("pass.build"):
                lanes[y_offset, dev] = render_lanes(scn, cfg, width, rows, spp, nn, y_offset,
                                                    dev, tile)
        return lanes[y_offset, dev]

    def run(cam_packed, seed, pass_idx, y_offset, dst=None, add=False, rays=None,
            loop_use=None):
        dev = cam_packed.device
        rec = telemetry.ACTIVE  # spans only inside a profiled Renderer.render
        pix, sub, tiled = lanes_of(y_offset, dev)
        t0 = telemetry.now() if rec else 0
        out, lane_rays = tracer.words(cam_packed, seed, pass_idx, pix, sub, loop_use=loop_use)
        if rec:
            telemetry.span("glue.trace", t0)
        if dst is None:
            if add:
                raise ValueError("add: a pass adds into the film rows it is given")
            dst = torch.empty((rows, width, 3), dtype=torch.float32, device=dev)
        if rays is None:
            rays = torch.zeros(1, dtype=torch.int64, device=dev)
        t0 = telemetry.now() if rec else 0
        accumulate(out, lane_rays, output, nn, dst, add=add, ray_total=rays,
                   pix=pix if tiled else None, pix0=y_offset * width)
        if rec:
            telemetry.span("glue.accumulate", t0)
        return dst, rays

    run.lanes = lambda y_offset, device: lanes_of(y_offset, torch.device(device))[:2]
    return run
