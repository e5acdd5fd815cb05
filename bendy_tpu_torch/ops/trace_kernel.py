"""The tracer as one CUDA kernel per pass, and its launch glue.

Counterpart of ``bendy_tpu/ops/pallas_trace.py``: ``make_tracer`` stands
for ``make_pallas_tracer`` and ``make_render_pass`` for
``make_pallas_render_pass``. The kernel is ``csrc/trace_surface.cu``, a
hand-written CUDA C++ kernel for sm_90a that runs the whole regenerating
wavefront loop of :func:`bendy_tpu_torch.ops.wavefront.trace_core`, one
thread per lane. That function is its plain version. The kernel has
compile-time instantiations behind three entry points, each with its own
launch count: the flat surface tracer (:func:`trace_surface`), the
geodesic one (:func:`trace_geodesic`, RK4 chord stepping over up to
``MAX_MASSES`` unrolled masses, or with ``cfg.looped_masses`` over any
count of masses in a loop that recomputes h² per RK4 stage: the LOOPM
instantiations) and the volume one (:func:`trace_volume`: march mode and
the density lookup of sparse and dense grids, with or without geodesics,
unrolled or looped). Primitives and lights are swept by run-time loops
over the table in every instantiation, so the reference's looped
primitive and light sweeps need no instantiation of their own. The LOOPM
instantiations run one thread per (lane, sample) instead, so that a
photon-ring pixel's long samples spread over threads, and a second kernel
(:func:`fold_samples`) adds each lane's samples in sample order, bit-equal
to one thread per lane.

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
would crowd the shared-memory table. Lanes are fed
row-major; the reference's tile-major lane order (``tile_perm``) changes
no pixel and is left as scheduling work.
"""

from __future__ import annotations

import numpy as np
import torch

from bendy_tpu_torch.geodesic import GeoParams
from bendy_tpu_torch.ops.bvh import (BOX_COLS, BVH_STACK, RCT_COLS, SPH_COLS, build_bvh,
                                     bvh_counts, uses_bvh)
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

# kernel flag bits (csrc/trace_surface.cu FLAG_*)
FLAG_DIFFUSE, FLAG_METALLIC, FLAG_GLASS, FLAG_DOF, FLAG_POLY, FLAG_GEO = 1, 2, 4, 8, 16, 32
FLAG_LOOPM = 64  # the looped mass sweep (the LOOPM instantiations)
FLAG_GTAB = 128  # the scene table stays in global memory
FLAG_BVH = 256  # nearest hits by the BVH walk (the looped-sweep scenes, ops/bvh.py)
# a BVH launch's walk stacks: uint16 node indices, BVH_STACK per thread of a
# 128-thread block, in shared memory after the staged table
BVH_STACK_BYTES = 2 * BVH_STACK * 128

# a looped-mass launch runs one thread per (lane, sample) into per-item
# buffers of n_out floats and N_COUNTS int32 counts (rays, iters, vevents,
# near_steps); past SPLIT_BUDGET_BYTES of them the wrapper launches the
# samples in chunks (at 1080p, 256 spp they would take 28 GB)
N_COUNTS = 4
SPLIT_BUDGET_BYTES = 256 << 20


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


def tracer_table(host: SceneArrays, cfg: TraceConfig) -> tuple[np.ndarray, dict]:
    """The kernel's table for ``cfg``: :func:`scene_table`, and for a
    configuration that walks the BVH (:func:`bendy_tpu_torch.ops.bvh.uses_bvh`)
    its node block appended after the mass block at a float4 boundary, so
    every earlier offset stays; the counts then also hold the block's offset
    ``bvh0`` and its ``n_node`` and ``n_key``."""
    table, counts = scene_table(host)
    if not uses_bvh(cfg):
        return table, counts
    o1 = counts["n_sph"] * SPH_COLS
    o2 = o1 + counts["n_rct"] * RCT_COLS
    block = build_bvh(table[:o1], table[o1:o2], table[o2:o2 + counts["n_box"] * BOX_COLS])
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
            | (FLAG_LOOPM if cfg.geodesic and cfg.looped_masses else 0))


def table_in_global(nbytes: int, bvh: bool = False) -> bool:
    """Whether a scene table of ``nbytes`` (node block included) stays in
    global memory (the GTAB instantiations) instead of being staged in
    shared memory, where a BVH launch also keeps its walk stacks."""
    return nbytes + (BVH_STACK_BYTES if bvh else 0) > MAX_TABLE_BYTES


def _check_launch(entry: str, dev: torch.device, rc: int) -> None:
    """Raise on a refused launch (``rc``, the C entry's cudaGetLastError())."""
    from bendy_tpu_torch import _build

    if rc != 0:
        msg = _build.library().bendy_cuda_error_string(rc).decode()
        raise RuntimeError(f"{entry} launch failed on {dev}: CUDA error {rc} ({msg})")


def _launch(entry: str, table: torch.Tensor, counts: dict, cam_packed: torch.Tensor,
            pix: torch.Tensor, sub: torch.Tensor, width: int, height: int, spp: int,
            spp_total: int, subsample: int, key: tuple, sample0: int,
            cfg: TraceConfig, extra: tuple = (), outs: tuple | None = None,
            max_iters: int | None = None, bvh_tests: torch.Tensor | None = None):
    """Check the arguments and launch the C entry point ``entry`` on the
    current stream; ``extra`` are the entry's arguments after
    ``bvh_tests``, where a tensor goes in as its pointer. ``outs`` (out,
    rays, iters) are the kernel's outputs (a looped-mass launch's per-item
    buffers), else allocated per lane; ``max_iters`` is the loop cap
    (default ``cfg.max_iters(spp)``). A table with a node block (``bvh0``
    in ``counts``) launches the BVH instantiation, which writes each lane's
    node and primitive test counts to ``bvh_tests`` ([2, B] int32) when it
    is given. Returns (out, rays, iters)."""
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
    if outs is None:
        n_out = N_OUT if cfg.want_aovs else 3
        outs = (torch.empty((n_out, B), dtype=torch.float32, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev))
    out, rays, iters = outs
    if B == 0:
        return out, rays, iters
    flags = (_flags(cfg) | (FLAG_GTAB if table_in_global(table.numel() * 4, bvh0 >= 0) else 0)
             | (FLAG_BVH if bvh0 >= 0 else 0))
    rc = getattr(_build.library(), entry)(
        table.data_ptr(), table.numel(), cam_packed.data_ptr(), pix.data_ptr(),
        sub.data_ptr(), out.data_ptr(), rays.data_ptr(), iters.data_ptr(),
        B, width, height, spp, subsample, spp_total & 0xFFFFFFFF,
        key[0] & 0xFFFFFFFF, key[1] & 0xFFFFFFFF, sample0 & 0xFFFFFFFF,
        cfg.max_bounces, cfg.max_iters(spp) if max_iters is None else max_iters,
        cfg.clip_min, cfg.clip_max, flags, counts["n_sph"], counts["n_rct"],
        counts["n_box"], counts["n_light"], counts["n_face"], int(cfg.want_aovs), bvh0,
        None if bvh_tests is None else bvh_tests.data_ptr(),
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in extra),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _check_launch(entry, dev, rc)
    return out, rays, iters


def split_samples(lanes: int, spp: int, n_out: int) -> int:
    """Samples per chunk of a looped-mass launch: as many as keep its
    per-item buffers within ``SPLIT_BUDGET_BYTES``, at least one (one
    sample's buffers are no larger than the lanes' own outputs)."""
    per_sample = max(lanes, 1) * 4 * (n_out + N_COUNTS)
    return max(1, min(spp, SPLIT_BUDGET_BYTES // per_sample))


_OVER_CAP: dict = {}  # device -> [1] int32 (over_cap_lanes)


def over_cap_lanes(device) -> torch.Tensor:
    """[1] int32 on ``device``: the lanes of every looped-mass launch there,
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


def _traced(entry: str, table, counts, cam_packed, pix, sub, width, height, spp, spp_total,
            subsample, key, sample0, cfg: TraceConfig, extra, vevents=None, near_steps=None,
            item_counts=None, bvh_tests=None):
    """Launch ``entry``: one thread per lane, or with looped masses one per
    (lane, sample) into per-item buffers, each chunk of samples followed by
    its ordered fold (:func:`fold_samples`) into the per-lane outputs.
    ``extra(near_steps, vevents)`` gives the entry's arguments after
    ``bvh_tests``. ``item_counts``, optional [N_COUNTS, B, spp] int32,
    receives a looped-mass launch's per-item counts (row 2, vevents, only
    with volumes). ``bvh_tests`` as for :func:`_launch`. Returns (out,
    rays, iters)."""
    if not (cfg.geodesic and cfg.looped_masses):
        return _launch(entry, table, counts, cam_packed, pix, sub, width, height, spp, spp_total,
                       subsample, key, sample0, cfg, extra=extra(near_steps, vevents),
                       bvh_tests=bvh_tests)
    dev, B = pix.device, pix.shape[0]
    if spp < 1:
        raise ValueError(f"a looped-mass launch traces at least one sample, got spp {spp}")
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
        _launch(entry, table, counts, cam_packed, pix, sub, width, height, s, spp_total,
                subsample, key, sample0 + c0, cfg, extra=extra(c[3], c[2]),
                outs=(f, c[0], c[1]), max_iters=cap)
        fold_samples(f, c, s, out, rays, iters, vevents, near_steps, first=c0 == 0,
                     max_iters=cap if c0 + s == spp else -1, over_cap=over_cap_lanes(dev))
        if item_counts is not None:
            item_counts[:, :, c0:c0 + s] = c.view(N_COUNTS, B, s)
    return out, rays, iters


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
                  bvh_tests: torch.Tensor | None = None):
    """Launch the flat surface instantiation of ``csrc/trace_surface.cu``
    on the current stream; the BVH one for a table of :func:`tracer_table`
    with a node block, whose per-lane node and primitive test counts go to
    ``bvh_tests`` ([2, B] int32) when it is given.

    Returns (out [3 or 10, B] f32 channel sums, rays [B] int32, iters
    [B] int32). Adds one to ``trace_surface.launches`` per launch. Raises
    on anything the kernel does not take and on a refused launch.
    """
    if cfg.geodesic or cfg.has_volumes:
        raise ValueError("a geodesic configuration launches trace_geodesic, one with "
                         "volumes trace_volume")
    res = _launch("bendy_trace_surface", table, counts, cam_packed, pix, sub, width,
                  height, spp, spp_total, subsample, key, sample0, cfg, bvh_tests=bvh_tests)
    if pix.shape[0]:
        trace_surface.launches += 1
    return res


trace_surface.launches = 0


def trace_geodesic(table: torch.Tensor, counts: dict, cam_packed: torch.Tensor,
                   pix: torch.Tensor, sub: torch.Tensor, *, width: int,
                   height: int, spp: int, spp_total: int, subsample: int,
                   key: tuple, sample0: int, cfg: TraceConfig,
                   near_steps: torch.Tensor | None = None,
                   item_counts: torch.Tensor | None = None):
    """Launch the geodesic instantiation of ``csrc/trace_surface.cu`` (RK4
    chord stepping; unrolled masses, or the LOOPM one with
    ``cfg.looped_masses``) on the current stream.

    Same outputs as :func:`trace_surface`; the ``GeoParams`` go in as
    launch arguments. With ``cfg.looped_masses`` the kernel runs one thread
    per (lane, sample) and the fold kernel adds each lane's samples in
    order (:func:`fold_samples`, chunks of :func:`split_samples`), with the
    same sums as one thread per lane; ``near_steps`` (an optional [B] int32
    output) receives each lane's count of RK4 steps and ``item_counts``
    those of :func:`_traced`. Adds one to ``trace_geodesic.launches`` per
    call. Raises unless ``cfg.geodesic`` without volumes and 1 <= n_mass
    (at most ``MAX_MASSES`` unless ``cfg.looped_masses``).
    """
    if cfg.has_volumes:
        raise ValueError("a configuration with volumes launches trace_volume")
    geo = _geo_args(counts, cfg)
    res = _traced("bendy_trace_geodesic", table, counts, cam_packed, pix, sub, width, height,
                  spp, spp_total, subsample, key, sample0, cfg,
                  lambda near, vev: (*geo, near),
                  near_steps=_near_steps(near_steps, pix, cfg), item_counts=item_counts)
    if pix.shape[0]:
        trace_geodesic.launches += 1
    return res


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
    """The optional per-lane RK4-step output of a looped-mass launch."""
    if near_steps is None:
        return None
    if (not cfg.looped_masses or near_steps.shape != pix.shape
            or near_steps.dtype != torch.int32 or near_steps.device != pix.device):
        raise ValueError("near_steps: a [B] int32 tensor beside the lanes, for looped_masses")
    return near_steps


def trace_volume(table: torch.Tensor, counts: dict, cam_packed: torch.Tensor,
                 pix: torch.Tensor, sub: torch.Tensor, grid: torch.Tensor, *, width: int,
                 height: int, spp: int, spp_total: int, subsample: int,
                 key: tuple, sample0: int, cfg: TraceConfig,
                 near_steps: torch.Tensor | None = None,
                 item_counts: torch.Tensor | None = None,
                 bvh_tests: torch.Tensor | None = None):
    """Launch the volume instantiation of ``csrc/trace_surface.cu`` (march
    mode and the 8-corner density lookup of ``grid``, the ``[G, D, H, W]``
    f32 stack of the scene's density grids; geodesic inside media when
    ``cfg.geodesic``) on the current stream.

    Returns (out, rays, iters) as :func:`trace_surface`, then vol_events
    [B] int32, each lane's count of volume events (density lookups);
    looped masses, ``near_steps`` and ``item_counts`` as for
    :func:`trace_geodesic`, the BVH and ``bvh_tests`` as for
    :func:`trace_surface`. Adds one to ``trace_volume.launches`` per
    call. Raises unless
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
        "bendy_trace_volume", table, counts, cam_packed, pix, sub, width, height, spp,
        spp_total, subsample, key, sample0, cfg,
        lambda near, vev: (*geo, near, grid, G, D, H, W, cfg.volume_step,
                           cfg.max_volume_bounces, int(cfg.vol_nearest), vev),
        vevents=vevents, near_steps=_near_steps(near_steps, pix, cfg), item_counts=item_counts,
        bvh_tests=bvh_tests)
    if pix.shape[0]:
        trace_volume.launches += 1
    return out, rays, iters, vevents


trace_volume.launches = 0


def make_tracer(scn: SceneArrays, width: int, height: int, spp: int,
                subsample: int, cfg: TraceConfig, spp_total: int | None = None):
    """Build the tracer for one compiled scene.

    Returns ``fn(cam_packed [1,32] f32, seed, pass_idx, pix [B], sub [B],
    sample0=0, count_tests=False) -> TraceSums``: on CUDA lane tensors the
    kernel (:func:`trace_volume` for a configuration with volumes, else
    :func:`trace_geodesic` for a geodesic one, else :func:`trace_surface`),
    on CPU ones the plain :func:`trace_core`. Each lane traces the samples
    [sample0, sample0+spp) of a global ``spp_total`` (default ``spp``), so
    the sharded pass splits samples over ranks with globally unique RNG
    streams. Ray, iteration and volume-event counts are int64 sums of
    per-lane counts, with the same meaning on both routes, and
    ``lane_counts`` holds the per-lane counts themselves. The looped-sweep
    scenes (``cfg.looped_sweep``) without geodesics walk a BVH built here
    once (:func:`tracer_table`); ``count_tests`` then adds each lane's node
    and primitive tests to ``lane_counts`` (``node_tests``,
    ``prim_tests``). The CPU route sweeps every primitive, the image the
    walk is held to.
    """
    spp_total = spp if spp_total is None else spp_total
    check_trace_args(width, height, spp_total, subsample, cfg)
    table_np, counts = tracer_table(scn.host_copy(), cfg)
    tables: dict = {}
    grids: dict = {}

    def run(cam_packed, seed, pass_idx, pix, sub, sample0: int = 0,
            count_tests: bool = False) -> TraceSums:
        key = render_key(seed, pass_idx)
        dev = pix.device
        if count_tests and ("bvh0" not in counts or dev.type != "cuda"):
            raise ValueError("count_tests: only the kernel's BVH walk counts its tests")
        if dev.type == "cpu":
            return trace_core(scn, unpack_camera(cam_packed), key, pix, sub, width,
                              height, spp, subsample, cfg, spp_total=spp_total,
                              sample0=sample0)
        if dev.type != "cuda":
            raise ValueError(f"no tracer for device {dev}")
        if dev not in tables:
            tables[dev] = torch.from_numpy(table_np).to(dev)
        kw = dict(width=width, height=height, spp=spp, spp_total=spp_total,
                  subsample=subsample, key=key, sample0=sample0, cfg=cfg)
        tests = None
        if count_tests:
            tests = torch.empty((2, pix.shape[0]), dtype=torch.int32, device=dev)
            kw["bvh_tests"] = tests
        lanes = (tables[dev], counts, cam_packed.reshape(-1), pix.to(torch.int32),
                 sub.to(torch.int32))
        if cfg.has_volumes:
            if dev not in grids:
                grids[dev] = scn.vol_grid.to(dev).contiguous()
            out, rays, iters, vol = trace_volume(*lanes, grids[dev], **kw)
        else:
            launch = trace_geodesic if cfg.geodesic else trace_surface
            out, rays, iters = launch(*lanes, **kw)
            vol = torch.zeros_like(rays)
        lane_counts = dict(rays=rays, iters=iters, vol_events=vol)
        if tests is not None:
            lane_counts.update(node_tests=tests[0], prim_tests=tests[1])
        sums = (rays.sum(dtype=torch.int64), iters.sum(dtype=torch.int64),
                vol.sum(dtype=torch.int64))
        rad = V3(out[0], out[1], out[2])
        if not cfg.want_aovs:
            return TraceSums(rad, rad, rad, rad.x, *sums, lane_counts=lane_counts)
        return TraceSums(rad, V3(out[3], out[4], out[5]), V3(out[6], out[7], out[8]),
                         out[9], *sums, lane_counts=lane_counts)

    return run


def pass_lanes(width: int, rows: int, nn: int, y_offset: int, device):
    """(pix, sub) int32 lanes of image rows [y_offset, y_offset+rows):
    (pixel, subpixel) in row-major order with global pixel ids, so any row
    chunking renders the same image."""
    local = torch.arange(rows * width * nn, dtype=torch.int32, device=device)
    return y_offset * width + local // nn, local % nn


def pixel_sums(res: TraceSums, output: str, rows: int, width: int, nn: int) -> torch.Tensor:
    """Per-lane sums of the requested channel -> per-pixel sums [rows,W,3]."""
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


def make_render_pass(scn: SceneArrays, width: int, height: int, rows: int,
                     spp: int, subsample: int, cfg: TraceConfig, output: str):
    """Counterpart of ``render.render_pass`` on the tracer: returns
    ``fn(cam_packed, seed, pass_idx, y_offset) -> (sums [rows,W,3], rays)``
    over image rows [y_offset, y_offset+rows), on ``cam_packed``'s device.
    """
    nn = max(subsample, 1) ** 2
    tracer = make_tracer(scn, width, height, spp, subsample, cfg)

    def run(cam_packed, seed, pass_idx, y_offset):
        pix, sub = pass_lanes(width, rows, nn, y_offset, cam_packed.device)
        res = tracer(cam_packed, seed, pass_idx, pix, sub)
        return pixel_sums(res, output, rows, width, nn), res.rays

    return run
