#!/usr/bin/env python3
"""Drive the bendy_tpu_torch main paths once on one CUDA card and check them.

    python3 chip_smoke.py      # from the repo root; builds the kernels itself

Phases, one line each (any failure exits non-zero):
  1. the card: needs torch.cuda.is_available(); prints nvidia-smi's name and
     power limit,
  2. builds the CUDA kernels from bendy_tpu_torch/csrc with nvcc and prints
     each instantiation's ptxas registers, stack and spills (surface,
     geodesic, and the volume ones with and without geodesics; the geodesic
     ones with unrolled masses, the item instantiations, and with looped
     masses, LOOPM; the volume ones without geodesics as item
     instantiations and with the BVH walk, BVH, as the surface ones too;
     each with the table in shared or in global memory, GTAB), of the fold
     kernel and of the probe kernels (csrc/probes.cu: the FP32 chains and
     each tile of the wgmma dot chain, and ptxas's warnings on wgmma, if
     any) and of the pass's accumulate kernel (csrc/accumulate.cu); then
     each item instantiation's register budget (minBlocks) and the blocks
     of 128 an SM holds, and the surface and LOOPM instantiations'; with
     run(parent=<the parent's checkout>) every tracer instantiation's
     opcodes and ptxas line against the parent's library, where only the
     LOOPM ones may differ (printed beside the parent's); then the SASS
     of the surface sweep per loop iteration, and of the geodesic item
     instantiation's (tools/sweep_sass.py, from a -lineinfo build of
     trace_surface.cu started beside the default one, held to the
     library's instructions): shared loads by width, FFMA, FMUL, FADD,
     FSETP, FSEL, FMNMX, MUFU, CALL, BSSY/BSYNC and branches of the sphere,
     rect and box loops and of light_pdf's face loop,
  3. kernel vs plain on the card: the surface kernel against the plain
     PyTorch integrator on cornell, cornell2 and scene at 16x16, 4 spp,
     max_bounces=3, seed 7, in FULL and NORMAL output, with the table in
     shared and in global memory; the geodesic kernel
     against it on blackhole and binary_blackhole at 16x16, spp 1 and 4,
     max_bounces=2, seed 3, FULL and NORMAL; the volume kernel on volume,
     cloud and dense_cloud at spp 2, max_bounces=3, seed 11, on
     blackhole_cloud at spp 1 and 4, Config(max_bounces=2,
     volume_step=0.6), seed 3, and on cloud with nearest sampling, FULL and
     NORMAL; the BVH instantiations forced on cornell, scene and cloud
     (also with the table in global memory); the looped sweeps, which walk
     the BVH: build_prim_grid(200), (1024) (a table past 48 KiB) and (3072)
     (past shared memory: read in global memory) at spp 2, max_bounces=4,
     seed 7, cloud_field at spp 2, max_bounces=4, seed 11,
     build_light_field(200) at spp 2, max_bounces=3, seed 5,
     mass_cluster at spp 1, 4 and 16, max_bounces=2, seed 3, a 13-mass
     ring at spp 2 and 12 masses inside a medium at spp 2 (the reference's
     multi_mass_scene), FULL and NORMAL (per lane rtol 5e-4, atol 1e-5,
     equal int64 ray counts and equal per-lane rays, iterations, volume
     events and (geodesics) RK4 steps; every case that runs per (lane,
     sample), geodesics and media without the BVH, with 0 lanes past the
     lane cap;
     every BVH case in FULL output also against the plain walk through the
     tracer, trace_core(bvh=...): bit-equal to the plain sweep, and equal
     per-lane node and primitive test counts to the kernel's);
     blackhole, cloud, blackhole_cloud at spp 4, mass_cluster at spp 4 and
     the medium case also with the table forced into global memory and
     with one sample per chunk; a flat table of 140,000 spheres (past the
     BVH walk's depth: the sweep instantiation, table in global memory) at
     spp 1, max_bounces=2, seed 9, FULL; then the Renderer
     against the cornell CPU golden at the same tolerance, and against the
     volume golden within the budget tests/test_torch_volume.py holds; and
     the accumulate kernel against its plain version, bit for bit, on
     seeded words of 37x29 pixels for every output at nn = 1 and 4, in add
     and store mode, with equal ray counts,
  4. the cornell main path: Renderer(cornell) at 256x256, 64 spp, 2x2
     subpixels, default Config, into a DeviceFilm — one warm-up pass, then
     4 chained timed passes (Mrays/s, seconds per pass, host ms per pass:
     the host time of the 4 render calls before the synchronize, over 4;
     the surface kernel's and the accumulate kernel's launch counts, the
     latter once per row chunk and pass); one more pass under
     torch.profiler, which must run no aten::arange, stack, cat, sum,
     zeros_like or add_ (only the tracer, the accumulate and
     allocations); every pass of the film again through the parent's route
     (the tracer's TraceSums, pixel_sums and +=), bit-equal at 1x1
     subpixels and past it within what two summation orders can differ
     by, with equal rays; then the kernel alone and one kernel pass
     (lanes, launch, accumulate), each the median and spread of 7 calls
     with fresh seeds between their own CUDA events after 0.5 s of
     warm-up, and the pass wall minus the kernel alone; the accumulate
     kernel alone, 20 launches in a CUDA graph, at the path's shape
     against its plain version (bit-equal) and against the parent's route
     (pixel_sums, += and the int64 ray sum); the
     lane loop's blocks, waves and warps per SM, rays per warp issue slot
     and block tail, and the ptxas line of every surface instantiation; and
     one plain pass at the same geometry and seed; the two passes are
     compared per pixel and by ray count,
  5. the blackhole main path (bench.py's blackhole_geodesic row):
     Renderer(blackhole, Config(max_bounces=2)) at 512x512, 32 spp, no
     subpixels, into a DeviceFilm — one warm-up pass, then 4 chained timed
     passes (the geodesic kernel's and the fold kernel's launch counts);
     the geodesic kernel alone (as in phase 4; its RK4 steps counted for the
     bound), its per-item and per-lane loop lengths, rays per warp issue
     slot and slowest block over the mean block, the blocks per SM, and
     the fold kernel alone; then one kernel pass and one plain pass at spp
     4, compared per pixel and by ray count,
  6. the cloud main path (sparse 16^3 grid): Renderer(cloud) at 256x256,
     64 spp, 2x2 subpixels, default Config, as phase 5, through the volume
     kernel and the march share (volume events over rays); one kernel pass
     and one plain pass at spp 4, compared,
  7. the dense_cloud main path (dense 32^3 grid), as phase 6,
  8. the blackhole_cloud main path (geodesics inside media, bench.py's
     blackhole_cloud row): 512x288, 32 spp, no subpixels,
     Config(max_bounces=2, volume_step=0.6), as phase 6,
  9. the prim_grid_256 main path (258 primitives, the looped primitive
     sweep, walked as a BVH; bench.py's prim_grid_256 row):
     build_prim_grid(256) at 256x256, 16 spp, no subpixels,
     Config(max_bounces=4), through the surface kernel, as phase 4 (the
     plain pass at spp 4), with the BVH's node and primitive tests per
     segment from one instrumented call and its bound (one primitive test
     per segment) beside the sweep's,
 10. the cloud_field main path (256 volume puffs and 2 sun lights, the
     looped sweep with media, the BVH): 256x256, 16 spp,
     Config(max_bounces=4), through the volume kernel, as phases 6 and 9,
 11. the mass_cluster main path (64 masses, the looped mass sweep): 256x256,
     16 spp, Config(max_bounces=2), through the LOOPM geodesic kernel (a
     resident grid whose threads take (lane, sample) items from a pool)
     and the fold kernel, as phase 5, with each lane's RK4 steps counted
     for the bound; the per-item and per-lane loop lengths and the slowest
     block over the mean block of one item and one lane a thread (the
     same paths); the tracer's own warp-use count of one call against its
     items' iterations, one item a thread's count and the pool model's,
     and the call against one item a thread's 56.469 ms; and the fold
     kernel alone against its plain version and torch.sum,
 12. the many-lights path (the looped light sweep; 201 primitives, the
     BVH): build_light_field(200) at 256x256, 16 spp, Config(max_bounces=3),
     through the surface kernel, as phase 9,
 13. the sharded pass (make_kernel_pass_sharded): (a) cornell at 256x256,
     64 spp, 2x2 subpixels, default Config on a (1,1) mesh, an NCCL world of
     one in this process: a warm-up pass, 4 chained passes with fresh seeds
     (Mrays/s, s per pass, launch counts: the tracer and the accumulate
     once a pass, no fold), the film bit-equal to the
     Renderer's pass at the same seed, the pass alone and the plain sharded
     pass at spp 4; (b) 2x2 meshes of 4 spawned gloo ranks sharing this
     card, on cornell at full size and on blackhole_cloud and mass_cluster
     at 64x64, 4 spp, each film within rtol/atol 2e-5 of the unsharded
     kernel pass with equal int64 rays,
 14. the CLI: python3 -m bendy_tpu_torch.cli on cornell 256x256, 64 spp,
     2x2, 16 spp per pass with --checkpoint in a subprocess, the film
     bit-equal to the same passes through the Renderer here; then --mesh 1x1,
 15. the probes: the FP32 chains (fma, nofma; FFMA/FADD counted in the
     SASS) and the bf16 dot chain (wgmma; HGMMA, F2FP, FADD, LDS and LDG of
     its loop counted in the SASS), each against its plain version at a
     small iteration count (the dot chain at each of the four tiles its plan
     takes, n 64-8192, the f32 control and random inputs, equal), then measured
     through tools/vpu_peak.measure and tools/mxu_shape_probe.measure (the
     dot chain at n 1024-8192 beside its cuBLAS yardstick; both with the SM
     clock and power draw read during their launches, the FP32 chain's
     share of its peak also at that clock).
 16. the bench: python3 -m bendy_tpu_torch.bench --full in this process into
     smoke_out/benches_results_torch.json (its headline JSON line printed on
     a line of its own): every reference row with a finite Mrays/s, its
     tracer launched in every timed pass, the headline's cornell median
     within 25 % of phase 4's Mrays/s, each row's occupancy equal to the
     rays per warp issue slot phases 4-12 print for the same path at the
     bench's seed, and the vpu_utilization_cornell row's FP32 shares in
     (0, 1]; each row joins its main path's tracer entry in the kernel line
     as a "bench" field,
 17. fidelity: python3 -m bendy_tpu_torch.tools.fidelity at its defaults on
     all 12 scenes into smoke_out/fidelity_torch.json (the port on the card,
     the C++ oracle on the host's cores), each entry held to
     docs/fidelity.json by check_against, its worst ratio printed,
 18. the lane order and the perf tools: (a) every main path of phases 4-12
     and the (1,1) sharded cornell pass rendered one pass with row-major
     lanes and one tile-major at the same key, bit-equal films and equal
     rays; (b) tools/perf_report.report on cornell and blackhole (FP32
     utilisation, every share in (0, 1]); (c) tools/block_sweep on cornell
     and cloud at 128 and 256 threads a block, tiled and not, 2 repeats,
     the 256-thread build (started beside phase 2's) first held to the
     plain version on phase 3's cornell and cloud cases.
 19. the probes of tools/: (a) the stub build of csrc/trace_surface.cu
     (-DBENDY_PHASE_STUBS, started beside phase 2's) prints its ptxas lines,
     its unstubbed instantiations' registers beside the default build's,
     and every instantiation it has, at every phase, is held to the plain
     trace with the same phase stubbed (tools/phase_probe.stubbed) on
     phase 3's cornell case (also forced onto the BVH) and cloud case, as
     phase 3 holds production; (b) tools/phase_probe on cornell (every
     phase), cloud (volume, marchspec, floor) and prim_grid_256 (sweep,
     floor), and cloud's march share; (c) tools/prim_scaling over both
     routes at 8-512 primitives, and the crossover; (d)
     tools/dispatch_probe on cornell and light_field_200, a captured
     graph's film bit-equal to the chain's. Each writes its JSON into
     smoke_out/; the phase split joins its main path's tracer entry in the
     kernel line.
 20. the tracer's warp-use counter at the benchmark's four cells (cornell
     256x256 2x2 64 spp and 768x512 2x2 1 spp, blackhole 1920x1080 256 spp
     with 2 bounces, mass_cluster 1920x1080 16 spp): one profiled pass each
     (telemetry.counters(), which the tracer counts itself) against
     ops/trace_kernel.warp_use of the same key's per-thread counts, integer
     for integer; on mass_cluster's LOOPM tracer, whose threads take items
     from a pool, its thread iterations equal the items' sum and it issues a
     multiple of 32 no fewer, beside one item a thread's count and the pool
     model's.
It prints the card's name and power limit, the kernel table as one JSON
line, then the result line {"ok": true, "device": {...}} last. On an H100
the whole run takes several minutes, most of it the plain passes and the
oracle.

    python3 -c "import chip_smoke as c; c.run(phases=(2, 3))"   # a subset
    python3 -c "import chip_smoke as c; c.run(phases=(2, 15))"  # the probes alone
    python3 -c "import chip_smoke as c; c.run(phases=(4, 16, 17))"  # bench, fidelity
    python3 -c "import chip_smoke as c; c.run(phases=(2, 19))"  # the probes of tools/
    python3 -c "import chip_smoke as c; c.run(phases=(2, 20))"  # the warp-use counter
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter

from bendy_tpu_torch._build import ptxas_report, trace_label
from bendy_tpu_torch.tools import (card, cuda_ms, cuda_ms_median, graph_ms,
                                   rays_per_warp_issue_slot)

SCENES = ("cornell", "cornell2", "scene")
GEO_SCENES = ("blackhole", "binary_blackhole")
VOL_SCENES = ("volume", "cloud", "dense_cloud")
RTOL, ATOL = 5e-4, 1e-5
# the volume golden: pixels the port may leave off it at the golden's own
# rtol 1e-5 / atol 1e-6 (8 of 256 on the CPU; tests/test_torch_volume.py)
VOLUME_GOLDEN_PIXELS_OFF = 16
PLAIN_BUDGET_S = 60.0  # a plain pass slower than this is narrowed to a row band
REPEATS = 7  # timed calls, each with a fresh seed, behind every kernel-alone median

# H100 SXM datasheet peaks: HBM bytes/s, FP32 non-tensor FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# FP32 operations per traced segment, counted from csrc/trace_surface.cu
# (a divide or a sqrt counts as one): the intersection test of each
# primitive kind, and per mass the capture/far/h² sweep that every
# geodesic segment runs.
SPHERE_OPS, RECT_OPS, BOX_OPS = 19, 37, 51
# A rect of the row sweep (nearest_hit_rows: the surface and geodesic
# launches without media or the BVH, their table staged) first tests
# whether its t may still win: q 5, p 8, the approximate reciprocal and the
# quotient 2, the margin 2 and a ± m 2 (compares are not counted, as in the
# three above). Only the rects that
# pass divide and test containment, and no counter of the default build
# says how many, so the bound counts this test alone for each rect: a floor.
RECT_REJECT_OPS = 19
# FP32 operations of the cheapest scattering material's shading, metallic,
# counted from csrc/trace_surface.cu: the four uniforms' scaling 4,
# unit_hemisphere 61 (sin_cos_tau 27, the radius 4, frame 13, the sum 17,
# sharing the radius's 1 - u2), reflect 12, the fuzz 6, normalize 10, the
# throughput 3. Each segment that scatters off a surface pays at least this
# much; at least rays - volume events - RK4 chords - samples segments do (a
# path's last traced segment does not scatter, and neither may a march step
# or a chord). The rest of the shading (emission, the AOVs, the
# regeneration) is not counted, so the bound is a floor.
SCATTER_OPS = 96
GEO_BEGIN_OPS, GEO_BEGIN_PER_MASS_OPS = 5, 21
# each RK4 step (a chord near a mass, counted per item by the kernel) is 4
# stages of the acceleration and 115 for the stage states, the two sums,
# the step size and the chord. The looped mass sweep (LOOPM): its begin
# sweep has no h² (17 per mass); its stage 5 for |d|² and 33 per mass (rel
# 3, r² 5, rel·d 5, h² 4, inv_r 3, inv_r⁵ 4, s 3, the sum 6). The unrolled
# masses' frozen-h² stage (acc_frozen): no |d|², 24 per mass (rel 3, r² 5,
# inv_r 3, inv_r⁵ 4, s 3, the sum 6)
LOOPM_BEGIN_PER_MASS_OPS, RK4_STEP_OPS, ACC_STAGE_OPS, ACC_PER_MASS_OPS = 17, 115, 5, 33
ACC_FROZEN_PER_MASS_OPS = 24
# FP32 operations of one volume event's density lookup, counted from
# csrc/trace_surface.cu: grid_axis 7 per axis (clamp 2, scale, floor,
# fraction, two weights), the nested lerp 21, the box coordinate 10, the
# density and the scatter test 2; the scatter itself is not counted
DENSITY_OPS = 54


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def lane_mismatch(a, b) -> int:
    """Lanes where |a-b| > atol + rtol·|b| (b is the plain version)."""
    return int(((a - b).abs() > ATOL + RTOL * b.abs()).sum())


def sm_clock() -> str:
    """The card's SM clock and power draw now, as nvidia-smi reads them."""
    c = card()
    return f"{c['clocks.sm']}, {c['power.draw']}"


def wgmma_warnings(log: str) -> list[str]:
    """ptxas's warnings about wgmma (a pipeline it serialized), each once."""
    return sorted({ln.strip() for ln in log.splitlines() if "wgmma" in ln.lower()
                   and ("warning" in ln.lower() or "performance" in ln.lower())})


def item_budgets() -> str:
    """Phase 2: each item instantiation's register budget (the blocks per
    SM its __launch_bounds__ asks for) and the blocks one SM holds, with a
    4 KiB table in shared memory and with the table in global memory
    (GTAB); the same of the surface instantiations (a budget of 1,024
    threads an SM in FULL output with the table staged, none with AOVs or
    GTAB: minBlocks 0) and of the LOOPM ones (their resident grid: the
    blocks one SM holds on every SM)."""
    from bendy_tpu_torch._build import TRACE_BLOCK
    from bendy_tpu_torch.ops.trace_kernel import MAX_TABLE_BYTES, item_occupancy
    from bendy_tpu_torch.ops.wavefront import TraceConfig

    parts = []
    for geo, vol, loopm in ((False, False, False), (True, False, False), (False, True, False),
                            (True, True, False), (True, False, True), (True, True, True)):
        for aovs in (False, True):
            for gtab, floats in ((0, 1024), (1, MAX_TABLE_BYTES // 4 + 1)):
                cfg = TraceConfig(geodesic=geo, has_volumes=vol, want_aovs=aovs,
                                  looped_masses=loopm)
                min_blocks, per_sm, sms = item_occupancy(cfg, floats)
                label = trace_label(int(aovs), int(geo), int(vol), int(loopm), gtab, 0)
                parts.append(f"{label}: minBlocks "
                             f"{min_blocks}, {per_sm} blocks of {TRACE_BLOCK} per SM "
                             f"({per_sm * TRACE_BLOCK // 32} warps) "
                             f"x {sms} SMs")
    return " | ".join(parts)


def trace_bound(counts: dict, table_floats: int, cfg, rays: int, lanes: int, samples: int,
                vol_events: int = 0, grid_floats: int = 0, rk4_steps: int = 0,
                sweep: bool = False, rows: bool = False) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations") for one
    tracer launch of ``samples`` paths (lanes x spp): each input read once
    (lanes, camera, scene table, density grids), each output written once
    (channel sums, per-lane rays and iterations, volume events with media,
    RK4 steps with geodesics), and the counted FP32 operations of every
    traced segment, every density lookup, (geodesics) every RK4 step and
    the least shading of the segments that must scatter (``SCATTER_OPS``)
    of this run. A segment's intersection counts one test of every primitive
    (the sweep), except on a table with a BVH, where it counts one test of
    the cheapest kind the scene has: the least any nearest-hit search must
    do, whatever implements it (``sweep`` counts the sweep there too: the
    sweep floor, printed beside it). ``rows``: the launch sweeps the float4
    rows (:func:`sweeps_rows`), where a rect counts ``RECT_REJECT_OPS``."""
    n_out = 10 if cfg.want_aovs else 3
    n_counts = 2 + cfg.has_volumes + cfg.geodesic
    nbytes = lanes * (8 + 4 * n_out + 4 * n_counts) + 4 * (table_floats + 32 + grid_floats)
    kinds = [(SPHERE_OPS, counts["n_sph"]), (RECT_REJECT_OPS if rows else RECT_OPS,
                                             counts["n_rct"]), (BOX_OPS, counts["n_box"])]
    if "bvh0" in counts and not sweep:
        per_ray = min((ops for ops, n in kinds if n), default=0)
    else:
        per_ray = sum(ops * n for ops, n in kinds)
    n_mass = counts["n_mass"]
    if cfg.geodesic:
        per_mass = LOOPM_BEGIN_PER_MASS_OPS if cfg.looped_masses else GEO_BEGIN_PER_MASS_OPS
        per_ray += GEO_BEGIN_OPS + per_mass * n_mass
    stage, per_mass = ((ACC_STAGE_OPS, ACC_PER_MASS_OPS) if cfg.looped_masses
                       else (0, ACC_FROZEN_PER_MASS_OPS))
    rk4_ops = rk4_steps * (RK4_STEP_OPS + 4 * (stage + per_mass * n_mass))
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    scatters = max(rays - vol_events - rk4_steps - samples, 0)
    t_ops = (rays * per_ray + vol_events * DENSITY_OPS + rk4_ops + scatters * SCATTER_OPS
             ) / PEAK_F32_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sweeps_rows(cfg, table_floats: int, counts: dict) -> bool:
    """Whether a launch of ``cfg`` with this table sweeps the float4 rows
    (csrc/trace_surface.cu SWEEP_ROWS): the library stages rows for it and
    its table is staged."""
    from bendy_tpu_torch import _build
    from bendy_tpu_torch.ops import trace_kernel

    lib = _build.library()
    return (trace_kernel.staged_floats(lib, cfg, table_floats, counts) > table_floats
            and not trace_kernel.stays_in_global(lib, cfg, table_floats, counts))


def warp_stats(rays, iters, what: str = "lane") -> str:
    """Per-thread loop-length spread and rays per warp issue slot
    (``tools.rays_per_warp_issue_slot``, the bench's occupancy); a thread is
    a lane, or an item (lane, sample) of a per-item launch."""
    it = iters.double()
    return (f"{what} loop lengths min {int(iters.min())} mean {float(it.mean()):.1f} "
            f"max {int(iters.max())}, rays per warp issue slot "
            f"{rays_per_warp_issue_slot(rays, iters):.3f}")


def block_tail(iters, threads: int | None = None) -> float:
    """The slowest block's loop length over the mean block's, a block's
    length being its slowest thread's (blocks of ``threads`` consecutive
    threads, default the build's ``TRACE_BLOCK``)."""
    from bendy_tpu_torch import _build

    threads = _build.TRACE_BLOCK if threads is None else threads
    n = iters.numel() // threads * threads
    blocks = iters[:n].view(-1, threads).max(dim=1).values.double()
    return float(blocks.max() / blocks.mean())


def mass_ring(n_masses: int):
    """The reference's multi_mass_scene (tests/test_looped_masses.py:45-72):
    a ring of masses and four emitters behind it."""
    import numpy as np

    from bendy_tpu_torch import Camera, Data, Material, Object, ObjectFlags, Scene, Sphere

    scene = Scene()
    env = scene.add_data(Data(Material.emissive((0.2, 0.22, 0.3), 0.05)))
    scene.set_root_material(env)
    scene.add_object(Object(Camera(focal_length=0.05, sensor_size=0.024, focus=None))
                     .with_tag("camera").with_translation([0.0, 0.0, 18.0]))
    for k in range(n_masses):
        ang = 2.0 * np.pi * k / n_masses
        rs = 0.05 * (1 + k % 3)
        scene.add_object(Object().with_tag(f"mass:{rs}").with_translation(
            [1.8 * np.cos(ang), 1.4 * np.sin(ang), 0.3 * (k % 2)]))
    for i, (px, py) in enumerate([(-4.0, 2.5), (3.5, -2.0), (0.2, 0.1), (5.0, 4.0)]):
        mat = scene.add_data(Data(Material.emissive((1.0, 0.8, 0.6), 1.5 + 0.3 * i)))
        scene.add_object(Object(Sphere(material=mat, radius=0.8))
                         .with_translation([px, py, -25.0]).with_flags(ObjectFlags.LIGHT))
    return scene


def mass_ring_medium(n_masses: int):
    """The ring inside a medium (tests/test_looped_masses.py:248-252)."""
    from bendy_tpu_torch import Data, DensityMap, Material, Object, Sphere

    scene = mass_ring(n_masses)
    vol = scene.add_data(Data(DensityMap.with_func(
        8, 8, 8, lambda x, y, z: 1.5 if (x + y + z) % 3 == 0 else 0.0)))
    shell = scene.add_data(Data(Material.flat((1.0, 1.0, 1.0))))
    scene.add_object(Object(Sphere(material=shell, radius=2.5, volume=vol)))
    return scene


def scene_by_name(name: str):
    """A generated scene by its name here, else scenes/<name>.json.gz."""
    import bendy_tpu_torch as bt

    generated = {
        "prim_grid_200": lambda: bt.build_prim_grid(200),
        "prim_grid_256": lambda: bt.build_prim_grid(256),
        "prim_grid_1024": lambda: bt.build_prim_grid(1024),  # table past 48 KiB
        "prim_grid_3072": lambda: bt.build_prim_grid(3072),  # table past shared memory
        "light_field_200": lambda: bt.build_light_field(200),
        "mass_ring_13": lambda: mass_ring(13),
        "mass_ring_12_medium": lambda: mass_ring_medium(12),
    }
    if name in generated:
        return generated[name]()
    return bt.load_scene(f"scenes/{name}.json.gz")


def renderer(name: str, config, width: int, height: int, dev):
    from bendy_tpu_torch import Renderer

    scene = scene_by_name(name)
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = width / height
    return Renderer(scene, config, device=dev), cam


def compare_lanes(tag: str, kern, plain, cfg, phase: int = 3) -> float:
    """Fail unless the kernel's TraceSums equal the plain version's per lane
    (rtol/atol) with equal int64 ray counts and equal per-lane rays,
    iterations, volume events and (geodesics) RK4 steps; returns the
    largest |diff|. Prints one line under ``phase``."""
    import torch

    fields = [("radiance", "xyz")]
    if cfg.want_aovs:
        fields += [("aov_albedo", "xyz"), ("aov_normal", "xyz")]
    pairs = [(getattr(getattr(kern, f), c), getattr(getattr(plain, f), c))
             for f, cs in fields for c in cs]
    if cfg.want_aovs:
        pairs.append((kern.aov_depth, plain.aov_depth))
    bad = sum(lane_mismatch(a, b) for a, b in pairs)
    err = max(float((a - b).abs().max()) for a, b in pairs)
    rays_k, rays_p = int(kern.rays), int(plain.rays)
    iters_k, iters_p = int(kern.iters), int(plain.iters)
    vol_k, vol_p = int(kern.vol_events), int(plain.vol_events)
    keys = [k for k in ("rays", "iters", "vol_events", "near_steps") if k in kern.lane_counts]
    counts_off = sum(int((kern.lane_counts[k].long() != plain.lane_counts[k]).sum())
                     for k in keys)
    chords = (f", RK4 steps kernel {int(kern.lane_counts['near_steps'].sum())} plain "
              f"{int(plain.lane_counts['near_steps'].sum())}" if "near_steps" in keys else "")
    print(f"phase {phase}: {tag}: lanes off {bad}, max |diff| {err:.3e}, rays kernel {rays_k} "
          f"plain {rays_p}, lane iterations kernel {iters_k} plain {iters_p}, volume events "
          f"kernel {vol_k} plain {vol_p}{chords}, per-lane counts off {counts_off} "
          f"({', '.join(keys)})")
    if (bad or counts_off or rays_k != rays_p or iters_k != iters_p or vol_k != vol_p
            or kern.rays.dtype != torch.int64):
        fail(f"kernel disagrees with plain on {tag}")
    return err


def golden_check(dev, name: str, pixels_off: int, rtol: float, atol: float) -> float:
    """Render the 16x16, 8 spp, max_bounces 3, seed 7 golden of ``name``
    through the Renderer on the card; fail if more than ``pixels_off``
    pixels leave it (``rtol``, ``atol``). Returns the largest |diff|."""
    import numpy as np

    from bendy_tpu_torch import Config, Film, RenderConfig, Subsample

    r, cam = renderer(name, Config(max_bounces=3), 16, 16, dev)
    film = Film(16, 16)
    r.render(cam, RenderConfig(samples=8, subsample=Subsample(1)), film, seed=7)
    golden = np.load(f"tests/golden/{name}_16x16_mb3_s8_seed7.npy")
    diff = np.abs(film.mean() - golden)
    off = int((diff > atol + rtol * np.abs(golden)).any(axis=-1).sum())
    err = float(diff.max())
    print(f"phase 3: {name} golden through the Renderer: pixels off {off} (allowed "
          f"{pixels_off}), max |diff| {err:.3e}")
    if off > pixels_off:
        fail(f"Renderer on the card misses the {name} golden")
    return err


GLOBAL_TABLE = {"MAX_TABLE_BYTES": 0}  # the GTAB instantiations on a small table
ONE_SAMPLE_CHUNKS = {"SPLIT_BUDGET_BYTES": 1}  # a per-item launch, one sample per chunk
BVH = {"looped_sweep": True}  # the BVH instantiations on a small scene (a TraceConfig field)


def phase3_cases() -> list:
    """(scene, spp, Config, seed, variants) of every kernel-vs-plain case at
    16x16: the kernel runs as the wrapper chooses, then once more under
    each variant's settings of ``ops/trace_kernel`` (and of the trace
    configuration, for BVH), all against one plain trace. The BVH is forced
    on cornell (rects and boxes, the walls always tested), scene.json (the
    ill-conditioned r = 100 ground sphere) and cloud (march steps), and
    with the table in global memory on cloud and on the three surface
    scenes."""
    from bendy_tpu_torch import Config, GeoParams

    cases = [(name, 4, Config(max_bounces=3), 7, (GLOBAL_TABLE,) + (BVH,) * (name != "cornell2"))
             for name in SCENES]
    cases += [(name, spp, Config(max_bounces=2), 3,
               ((GLOBAL_TABLE,) + (ONE_SAMPLE_CHUNKS,) * (name == "blackhole")) * (spp == 4))
              for name in GEO_SCENES for spp in (1, 4)]
    cases += [(name, 2, Config(max_bounces=3), 11,
               (GLOBAL_TABLE, BVH, {**GLOBAL_TABLE, **BVH}, ONE_SAMPLE_CHUNKS)
               if name == "cloud" else ())
              for name in VOL_SCENES]
    cases += [("blackhole_cloud", spp, Config(max_bounces=2, volume_step=0.6), 3,
               (GLOBAL_TABLE, ONE_SAMPLE_CHUNKS) * (spp == 4)) for spp in (1, 4)]
    cases += [("cloud", 2, Config(max_bounces=3, vol_sampling="nearest"), 11, ())]
    # the looped sweeps: primitives (with tables past 48 KiB and past shared
    # memory), primitives with media, lights, masses (split over samples,
    # and in chunks of one sample)
    cases += [("prim_grid_200", 2, Config(max_bounces=4), 7, ()),
              ("prim_grid_1024", 2, Config(max_bounces=4), 7, ()),
              ("prim_grid_3072", 2, Config(max_bounces=4), 7, ()),
              ("cloud_field", 2, Config(max_bounces=4), 11, ()),
              ("light_field_200", 2, Config(max_bounces=3), 5, ())]
    cases += [("mass_cluster", spp, Config(max_bounces=2), 3,
               (GLOBAL_TABLE, ONE_SAMPLE_CHUNKS) * (spp == 4)) for spp in (1, 4, 16)]
    cases += [("mass_ring_13", 2, Config(max_bounces=2, geo=GeoParams(max_steps=96)), 3, ()),
              ("mass_ring_12_medium", 2, Config(max_bounces=2, max_volume_bounces=8,
                                                 geo=GeoParams(max_steps=64)), 21,
               (GLOBAL_TABLE, ONE_SAMPLE_CHUNKS))]
    return cases


@contextlib.contextmanager
def trace_kernel_settings(settings: dict):
    """``ops/trace_kernel``'s module settings as given, for one block (keys
    that name a TraceConfig field are not module settings: see
    :func:`variant_config`)."""
    from bendy_tpu_torch.ops import trace_kernel

    settings = {k: v for k, v in settings.items() if hasattr(trace_kernel, k)}
    old = {k: getattr(trace_kernel, k) for k in settings}
    for k, v in settings.items():
        setattr(trace_kernel, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(trace_kernel, k, v)


def variant_config(cfg, settings: dict):
    """``cfg`` with the variant's TraceConfig fields (``looped_sweep``: the
    BVH on any scene in flat space; the plain trace does not depend on it)."""
    from dataclasses import fields, replace

    names = {f.name for f in fields(cfg)}
    return replace(cfg, **{k: v for k, v in settings.items() if k in names})


def walk_check(tag: str, r, cfg, kern, plain, table_np, counts, seed: int, spp: int, pix, sub,
               dev) -> None:
    """Hold a BVH kernel's winners against the plain walk through the
    tracer: trace_core with ``nearest_hit_bvh_plain`` in place of the sweep
    renders the plain sweep's image bit for bit with the same per-lane
    counts, the kernel's within rtol/atol, and the kernel's per-lane node
    and primitive test counts equal the plain walk's (the same tree, the
    same f32 node tests, the same order)."""
    import torch

    from bendy_tpu_torch.ops.bvh import bvh_tables
    from bendy_tpu_torch.ops.wavefront import trace_core
    from bendy_tpu_torch.utils.rng import render_key

    W = H = 16
    tables = bvh_tables(table_np[counts["bvh0"]:], dev)
    t0 = time.perf_counter()
    walk = trace_core(r.arrays, r.camera_params(r.scene.find_by_tag("camera")),
                      render_key(seed, 0), pix, sub, W, H, spp, 1, cfg, bvh=tables)
    walk_s = time.perf_counter() - t0
    def channels(res):
        return [getattr(getattr(res, f), c) for f in ("radiance", "aov_albedo", "aov_normal")
                for c in "xyz"] + [res.aov_depth]

    bit_equal = all(torch.equal(a, b) for a, b in zip(channels(walk), channels(plain))) and all(
        torch.equal(walk.lane_counts[k], plain.lane_counts[k])
        for k in ("rays", "iters", "vol_events"))
    tests_off = sum(int((kern.lane_counts[k].long() != walk.lane_counts[k]).sum())
                    for k in ("node_tests", "prim_tests"))
    rays = int(walk.rays)
    per = {k: int(walk.lane_counts[k].sum()) / max(rays, 1) for k in ("node_tests", "prim_tests")}
    print(f"phase 3: {tag}: the plain walk through the tracer bit-equal to the plain sweep "
          f"{bit_equal}; kernel vs plain walk per-lane node and primitive tests off {tests_off} "
          f"({per['node_tests']:.2f} node and {per['prim_tests']:.2f} primitive tests per "
          f"segment, plain walk {walk_s:.1f} s)")
    compare_lanes(f"{tag} against the plain walk", kern, walk, cfg)
    if not bit_equal or tests_off:
        fail(f"the BVH walk of {tag} disagrees with the sweep or the kernel's walk")


OUTPUTS = ("full", "albedo", "normal", "depth")


def accumulate_vs_plain(dev) -> float:
    """Phase 3: the accumulate kernel against its plain version on seeded
    words of 37x29 pixels (blocks of 128 pixels with a ragged last one):
    every output at nn = 1 and 4, in add mode (onto a seeded film) and in
    store mode, with row-major lanes and with tile-major ones (rows 5-41 of
    the image, ``pass_lanes(tile=True)`` at 128 lanes a block: tiles of 16
    x 8 and 4 x 8 pixels with a ragged right edge and trailing rows), bit
    for bit, with equal int64 ray counts. Returns the largest |diff| (0 when
    they agree)."""
    import torch

    from bendy_tpu_torch.ops.trace_kernel import (accumulate, accumulate_plain, pass_lanes,
                                                  tile_perm)

    rows, W, y0 = 37, 29, 5
    g = torch.Generator(device=dev).manual_seed(23)
    worst = 0.0
    for nn in (1, 4):
        B = rows * W * nn
        out = torch.randn((10, B), generator=g, device=dev) * 10.0 ** torch.randint(
            -4, 4, (10, B), generator=g, device=dev)
        rays = torch.randint(0, 500, (B,), generator=g, device=dev, dtype=torch.int32)
        film = torch.rand((rows, W, 3), generator=g, device=dev)
        tiled, _ = pass_lanes(W, rows, nn, y0, dev, tile=True, lanes_per_block=128)
        tiling = tile_perm(W, rows, nn, 128)[1]
        for order, pix in (("row-major", None), (f"tile-major {tiling}", tiled)):
            for output in OUTPUTS:
                for add in (True, False):
                    got, want = film.clone(), film.clone()
                    rk = torch.full((1,), 5, dtype=torch.int64, device=dev)
                    rp = rk.clone()
                    accumulate(out, rays, output, nn, got, add=add, ray_total=rk, pix=pix,
                               pix0=y0 * W)
                    accumulate_plain(out, rays, output, nn, want, add=add, ray_total=rp,
                                     pix=pix, pix0=y0 * W)
                    torch.cuda.synchronize()
                    equal = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
                    err = float((got - want).abs().max())
                    worst = max(worst, err)
                    print(f"phase 3: accumulate {output} nn {nn} {'add' if add else 'store'} "
                          f"at {rows}x{W} pixels, {order} lanes: bit-equal to its plain version "
                          f"{equal}, rays {int(rk)} vs {int(rp)}")
                    if not equal or int(rk) != int(rp):
                        fail(f"accumulate disagrees with its plain version ({output}, nn {nn}, "
                             f"{order})")
    return worst


SPHERE_FIELD = 140_000  # spheres: a median tree 17 deep, past the kernel's uint16 walk


def sphere_field(n: int, dev):
    """build_prim_grid(2)'s scene on ``dev`` with its sphere block replaced
    by ``n`` seeded small diffuse spheres over the field (the flat table of
    tests/test_torch_pass.py): (scene arrays, packed camera, TraceConfig
    with the looped sweep at max_bounces=2)."""
    from dataclasses import replace

    import numpy as np

    import bendy_tpu_torch as bt
    from bendy_tpu_torch.scene.compiler import MAT_DIFFUSE, scene_arrays_from_numpy

    r = bt.Renderer(bt.build_prim_grid(2), device=dev)
    cam = r.scene.find_by_tag("camera")
    r.camera_params(cam)
    g = np.random.default_rng(3)
    f32 = np.float32
    center = np.stack([g.uniform(-2.2, 2.2, n), g.uniform(0.05, 1.5, n),
                       g.uniform(-2.2, 2.2, n)], axis=1).astype(f32)
    host = replace(r.arrays.host_copy(), sph_center=center,
                   sph_radius=g.uniform(0.01, 0.03, n).astype(f32),
                   sph_mtype=np.full(n, MAT_DIFFUSE, np.int32),
                   sph_albedo=g.uniform(0.2, 0.9, (n, 3)).astype(f32),
                   sph_rough=np.zeros(n, f32), sph_ior=np.full(n, 1.5, f32),
                   sph_emitted=np.zeros((n, 3), f32), sph_vol_grid=np.full(n, -1, np.int32),
                   sph_vol_size=np.zeros((n, 3), f32))
    cfg = replace(r.trace_config(r.config, cam), max_bounces=2, looped_sweep=True,
                  has_diffuse=True)
    return scene_arrays_from_numpy(host, dev), r._cam_packed, cfg


def sweep_past_the_walk(dev) -> float:
    """Phase 3: the flat table of SPHERE_FIELD spheres, whose tree the
    kernel's walk cannot hold, at 16x16, spp 1, seed 9, FULL: no node
    block (the sweep instantiation, the table in global memory), one
    trace_surface launch, per lane against the plain sweep. Returns the
    largest |diff|."""
    import torch

    from bendy_tpu_torch import _build
    from bendy_tpu_torch.ops import trace_kernel
    from bendy_tpu_torch.ops.trace_kernel import make_tracer, tracer_table, unpack_camera
    from bendy_tpu_torch.ops.wavefront import trace_core
    from bendy_tpu_torch.utils.rng import render_key

    W = H = 16
    seed = 9
    arrays, cam_packed, cfg = sphere_field(SPHERE_FIELD, dev)
    t0 = time.perf_counter()
    table_np, counts = tracer_table(arrays.host_copy(), cfg)
    table_s = time.perf_counter() - t0
    pix = torch.arange(W * H, dtype=torch.int32, device=dev)
    sub = torch.zeros_like(pix)
    t0 = time.perf_counter()
    plain = trace_core(arrays, unpack_camera(cam_packed), render_key(seed, 0), pix, sub, W, H,
                       1, 1, cfg)
    plain_s = time.perf_counter() - t0
    before = trace_kernel.trace_surface.launches
    kern = make_tracer(arrays, W, H, 1, 1, cfg)(cam_packed, seed, 0, pix, sub)
    torch.cuda.synchronize()
    launches = trace_kernel.trace_surface.launches - before
    gtab = trace_kernel.stays_in_global(_build.library(), cfg, table_np.size, counts)
    print(f"phase 3: {SPHERE_FIELD} spheres: node block {'bvh0' in counts}, table "
          f"{table_np.nbytes} B in {'global' if gtab else 'shared'} memory (routed in "
          f"{table_s:.2f} s), trace_surface launches {launches}")
    if "bvh0" in counts or launches != 1:
        fail(f"the {SPHERE_FIELD}-sphere table did not run the sweep instantiation once")
    return compare_lanes(f"{SPHERE_FIELD} spheres spp 1 full looped_sweep, the sweep "
                         f"(plain {plain_s:.1f} s)", kern, plain, cfg)


def kernel_vs_plain(dev, names=None) -> dict:
    """Phase 3 (the cases of ``names`` only, and no goldens, when given);
    returns the largest |diff| of each kernel against the plain version,
    keyed by its wrapper's name. Every looped-mass case also holds the
    over-cap count (csrc/trace_surface.cu, "The cap") at 0; every BVH run
    in FULL output is also held to the plain walk (:func:`walk_check`)."""
    import torch

    from dataclasses import replace

    from bendy_tpu_torch import Output, _build
    from bendy_tpu_torch.ops import trace_kernel
    from bendy_tpu_torch.ops.trace_kernel import (make_tracer, over_cap_lanes, per_item,
                                                  split_samples)
    from bendy_tpu_torch.ops.wavefront import trace_core
    from bendy_tpu_torch.utils.rng import render_key

    W = H = 16
    pix = torch.arange(W * H, dtype=torch.int32, device=dev)
    sub = torch.zeros(W * H, dtype=torch.int32, device=dev)
    worst = {"trace_surface": 0.0, "trace_geodesic": 0.0, "trace_volume": 0.0}
    for name, spp, config, seed, variants in phase3_cases():
        if names is not None and name not in names:
            continue
        for output in (Output.FULL, Output.NORMAL):
            r, cam = renderer(name, replace(config, output=output), W, H, dev)
            cfg = r.trace_config(r.config, cam)
            params = r.camera_params(cam)
            t0 = time.perf_counter()
            plain = trace_core(r.arrays, params, render_key(seed, 0), pix, sub, W, H, spp, 1, cfg)
            plain_s = time.perf_counter() - t0
            for settings in ({}, *variants):
                cfg_k = variant_config(cfg, settings)
                table_np, counts = trace_kernel.tracer_table(r.arrays.host_copy(), cfg_k)
                bvh = "bvh0" in counts
                with trace_kernel_settings(settings):
                    over_cap_lanes(dev).zero_()
                    kern = make_tracer(r.arrays, W, H, spp, 1, cfg_k)(
                        r._cam_packed, seed, 0, pix, sub, count_tests=bvh,
                        count_steps=cfg_k.geodesic)
                    torch.cuda.synchronize()
                    over = int(over_cap_lanes(dev))
                    gtab = trace_kernel.stays_in_global(_build.library(), cfg_k, table_np.size,
                                                        counts)
                    chunks = -(-spp // split_samples(W * H, spp, 10 if cfg.want_aovs else 3))
                loops = [f for f in ("looped_sweep", "looped_lights", "looped_masses")
                         if getattr(cfg_k, f)]
                tag = (f"{name} spp {spp} {output.value}"
                       + (" nearest" if cfg.vol_nearest else "")
                       + "".join(f" {f}" for f in loops)
                       + (f" bvh ({counts['n_node']} nodes)" if bvh else "")
                       + f", table {table_np.nbytes} B in {'global' if gtab else 'shared'} memory"
                       + (f", {chunks} chunk(s), over-cap lanes {over}"
                          if per_item(cfg_k, bvh) else "")
                       + f" (plain {plain_s:.1f} s)")
                err = compare_lanes(tag, kern, plain, cfg)
                if over:
                    fail(f"{over} lanes of {tag} passed the lane cap")
                if bvh and output is Output.FULL:
                    walk_check(tag, r, cfg_k, kern, plain, table_np, counts, seed, spp, pix, sub,
                               dev)
                kind = ("trace_volume" if cfg.has_volumes else
                        "trace_geodesic" if cfg.geodesic else "trace_surface")
                worst[kind] = max(worst[kind], err)
    if names is None or "sphere_field" in names:
        worst["trace_surface"] = max(worst["trace_surface"], sweep_past_the_walk(dev))
    if names is None:
        worst["trace_surface"] = max(worst["trace_surface"],
                                     golden_check(dev, "cornell", 0, RTOL, ATOL))
        golden_check(dev, "volume", VOLUME_GOLDEN_PIXELS_OFF, 1e-5, 1e-6)
    if names is None or "accumulate" in names:
        worst["accumulate"] = accumulate_vs_plain(dev)
    return worst


# aten ops a main-path pass must not run: the lanes, the subpixel sums, the
# cat of row chunks, the ray sums and the film add of the parent's pass glue
GLUE_OPS = ("aten::arange", "aten::stack", "aten::cat", "aten::sum", "aten::zeros_like",
            "aten::add_", "aten::remainder", "aten::floor_divide", "aten::div")


def main_path(phase: int, name: str, config, W: int, H: int, spp: int, n: int, dev,
              launch) -> dict:
    """Drive one main path: a warm-up pass, then 4 chained passes into a
    DeviceFilm with every launch count set to 0 just before them; fails
    unless ``launch`` (the path's kernel wrapper) launched its kernel once
    per pass, or on a per-item path once per chunk of samples
    (:func:`sample_chunks`), each launch followed by one of the fold
    kernel, and the accumulate kernel once per row chunk and pass. Host ms
    per pass: the host time of the 4 render calls, before the synchronize,
    over 4. Then one more pass under torch.profiler (no op of
    ``GLUE_OPS``) and :func:`parent_route_check`."""
    import numpy as np
    import torch

    from bendy_tpu_torch import DeviceFilm, RenderConfig, Subsample
    from bendy_tpu_torch.ops.trace_kernel import accumulate, fold_samples

    r, cam = renderer(name, config, W, H, dev)
    cfg = r.trace_config(r.config, cam)
    chunks = sample_chunks(cfg, W * H * n * n, spp)
    row_chunks = -(-H // min(H, max(1, r.max_lanes // (W * n * n))))
    rc = RenderConfig(samples=spp, subsample=Subsample(n))
    seed = int.from_bytes(os.urandom(4), "little")
    film = DeviceFilm(W, H, device=dev)
    r.render(cam, rc, film, seed=seed)  # warm-up (and first-use build)
    film.synchronize()
    rays0 = r.rays_traced
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(4):
        r.render(cam, rc, film, seed=seed)
    host_s = time.perf_counter() - t0
    film.synchronize()
    dt = time.perf_counter() - t0
    launches, folds, accs = launch.launches, fold_samples.launches, accumulate.launches
    rays = r.rays_traced - rays0
    mean = film.mean()
    print(f"phase {phase}: main path {name} {W}x{H} {spp} spp {n}x{n}: 4 passes in {dt:.4f} s, "
          f"{dt / 4:.4f} s/pass, host ms per pass {host_s / 4 * 1e3:.3f}, {rays} rays "
          f"({rays // 4} per pass), {rays / dt / 1e6:.1f} Mrays/s, {launch.__name__} launches "
          f"{launches}, fold_samples launches {folds}, accumulate launches {accs} "
          f"({row_chunks} row chunk(s) a pass)")
    if launches != 4 * chunks:
        fail(f"main path launched {launch.__name__} {launches} times, expected 4 x {chunks}")
    if folds != (launches if is_per_item(cfg) else 0):
        fail(f"main path launched fold_samples {folds} times, expected one per tracer launch")
    if accs != 4 * row_chunks:
        fail(f"main path launched accumulate {accs} times, expected 4 x {row_chunks}")
    if not (np.isfinite(mean).all() and mean.shape == (H, W, 3) and mean.mean() > 0):
        fail(f"{name} main-path film is not finite and non-zero")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.render(cam, rc, film, seed=seed)
        film.synchronize()
    ops = {e.key: e.count for e in prof.key_averages() if e.key.startswith("aten::")}
    glue = sorted(set(ops) & set(GLUE_OPS))
    print(f"phase {phase}: torch ops of one pass: {ops or 'none'}")
    if glue:
        fail(f"a {name} pass ran the pass glue's ops {glue}")
    parent_route_check(phase, r, cam, film, rc, seed)
    return dict(r=r, cam=cam, seed=seed, rays=rays, dt=dt, host_s=host_s, launches=launches,
                folds=folds, chunks=chunks, accumulates=accs)


def parent_route_check(phase: int, r, cam, film, rc, seed: int) -> None:
    """Every pass of ``film`` again through the parent's route: the
    tracer's TraceSums over the whole image, ``pixel_sums`` and ``+=`` in
    the film's order, the rays by ``int64`` sums. Fails unless the rays
    are equal and the films bit-equal at 1x1 subpixels; past that,
    ``torch.sum`` adds a pixel's subpixels in another order than the
    accumulate's, so the films must agree within what any two orders can
    differ by: per pass 2 (nn - 1) u sum |x_s| (u = 2^-24) for the
    subpixel sums, and 2 u |film| for each film add of the two routes."""
    import numpy as np
    import torch

    from bendy_tpu_torch.ops.trace_kernel import make_tracer, pass_lanes, pixel_sums

    W, H, n = film.width, film.height, max(rc.subsample.n, 1)
    nn = n * n
    cfg = r.trace_config(r.config, cam)
    tracer = make_tracer(r.arrays, W, H, rc.samples, n, cfg)
    pix, sub = pass_lanes(W, H, nn, 0, film.device)
    old = torch.zeros_like(film.sum)
    mags = torch.zeros_like(film.sum, dtype=torch.float64)
    rays = 0
    for p in range(film.passes):
        res = tracer(r._cam_packed, seed, p, pix, sub)
        old += pixel_sums(res, "full", H, W, nn)
        mags += torch.stack([c.abs().double().reshape(H, W, nn).sum(dim=2)
                             for c in res.radiance], dim=-1)
        rays += int(res.rays)
    a, b = film.sum.cpu().numpy(), old.cpu().numpy()
    top = np.maximum(np.abs(a), np.abs(b)).astype(np.float64)
    diff = np.abs(a.astype(np.float64) - b)
    u = 2.0**-24
    bound = (2 * (nn - 1) * u * mags.cpu().numpy() + 2 * u * film.passes * top) * (1 + 1e-6)
    ulps = diff / np.spacing(top.astype(np.float32))
    equal = bool(torch.equal(film.sum, old))
    print(f"phase {phase}: the film's {film.passes} passes through the parent's route (pixel_sums "
          f"and +=): bit-equal {equal}, pixels off {int((a != b).any(axis=-1).sum())}, max "
          f"{float(ulps.max()):.1f} ulp, max |diff| over the two orders' bound "
          f"{float((diff / np.maximum(bound, 1e-45)).max()):.3f}; rays {rays} vs {r.rays_traced}")
    if rays != r.rays_traced or (nn == 1 and not equal) or (diff > bound).any():
        fail("the accumulate's film or rays differ from the parent's route")


def is_per_item(cfg) -> bool:
    """Whether the tracer runs ``cfg`` per (lane, sample) item, then folds."""
    from bendy_tpu_torch.ops.bvh import uses_bvh
    from bendy_tpu_torch.ops.trace_kernel import per_item

    return per_item(cfg, uses_bvh(cfg))


def sample_chunks(cfg, lanes: int, spp: int) -> int:
    """Tracer launches in one call of ``lanes`` lanes at ``spp``: one, or on
    a per-item path one per chunk of samples (``split_samples``)."""
    from bendy_tpu_torch.ops.trace_kernel import split_samples

    if not is_per_item(cfg):
        return 1
    return -(-spp // split_samples(lanes, spp, 10 if cfg.want_aovs else 3))


def kernel_alone_and_passes(phase: int, run: dict, W: int, H: int, spp: int, n: int,
                            pass_spp: int, plain_rows: int, launch, dev) -> dict:
    """Time the kernel alone at the main-path shape (the median and spread
    of REPEATS calls of the wrapper, each between its own CUDA events with
    a fresh seed, after at least 0.5 s of warm-up calls; the SM clock and
    power read after them; per launch, the call's time over its launches,
    on a per-item path each with its fold), then one kernel pass (timed
    the same way) and one plain pass at ``pass_spp`` over the first
    ``plain_rows`` rows, compared per pixel and by ray count. The kernel
    alone runs on the lanes in the Renderer's order (``render_lanes`` at
    the pass's default ``TILE``). It prints the
    per-lane loop lengths and block tail; a per-item path
    (:func:`is_per_item`) also its per-item ones, the blocks per SM (the
    item instantiations) and the fold kernel alone (:func:`fold_alone`),
    and the rays per warp issue slot of one more call at the bench's
    occupancy seed (``bench.OCCUPANCY_SEED``), which phase 16 holds the
    bench's row to. Returns the timings and the bound per launch, the
    largest |diff| and that occupancy."""
    import torch

    from bendy_tpu_torch import _build
    from bendy_tpu_torch.bench import OCCUPANCY_SEED
    from bendy_tpu_torch.ops.trace_kernel import (TILE, item_occupancy, make_render_pass,
                                                  render_lanes, tracer_table)
    from bendy_tpu_torch.render import render_pass
    from bendy_tpu_torch.utils.rng import render_key

    r, cam, seed = run["r"], run["cam"], run["seed"]
    cfg = r.trace_config(r.config, cam)
    nn = n * n
    t0 = time.perf_counter()
    table_np, counts = tracer_table(r.arrays.host_copy(), cfg)
    table_s = time.perf_counter() - t0
    bvh = "bvh0" in counts
    table = torch.from_numpy(table_np).to(dev)
    pix, sub, tiled = render_lanes(r.arrays, cfg, W, H, spp, nn, 0, dev, TILE)
    lanes = (table, counts, r._cam_packed.reshape(-1), pix, sub)
    grid = r.arrays.vol_grid.contiguous() if cfg.has_volumes else None
    if grid is not None:
        lanes += (grid,)
    items = is_per_item(cfg)
    chunks = sample_chunks(cfg, pix.numel(), spp)

    keys = [render_key(seed + i, 0) for i in range(REPEATS + 1)]  # host work, not timed

    def call(i, **more):
        return launch(*lanes, width=W, height=H, spp=spp, spp_total=spp, subsample=n,
                      key=keys[i], sample0=0, cfg=cfg, **more)

    res, call_ms, call_lo, call_hi = cuda_ms_median(call, REPEATS)
    clock = sm_clock()
    occ = launch(*lanes, width=W, height=H, spp=spp, spp_total=spp, subsample=n,
                 key=render_key(OCCUPANCY_SEED, 0), sample0=0, cfg=cfg)
    occupancy = rays_per_warp_issue_slot(occ[1], occ[2])
    print(f"phase {phase}: rays per warp issue slot at the bench's occupancy seed "
          f"{OCCUPANCY_SEED}: {occupancy!r}")
    rays, iters = res[1], res[2]
    item_counts = None
    if items:  # an instrumented call: each item's counts (RK4 steps in row 3)
        item_counts = torch.empty((4, pix.numel(), spp), dtype=torch.int32, device=dev)
        res = call(REPEATS, item_counts=item_counts)
        rays, iters = res[1], res[2]
    n_rays = int(rays.sum(dtype=torch.int64))
    n_vol = int(res[3].sum(dtype=torch.int64)) if grid is not None else 0
    n_rk4 = int(item_counts[3].sum(dtype=torch.int64)) if cfg.geodesic else 0
    bound_args = (counts, table.numel(), cfg, n_rays, pix.numel(), pix.numel() * spp, n_vol,
                  0 if grid is None else grid.numel(), n_rk4)
    rows = sweeps_rows(cfg, table.numel(), counts)
    bound_ms, bound_by = trace_bound(*bound_args, rows=rows)
    sweep_ms, _ = trace_bound(*bound_args, sweep=True, rows=rows)
    kernel_ms, kernel_lo, kernel_hi = (t / chunks for t in (call_ms, call_lo, call_hi))
    march = f", march share {n_vol / n_rays:.4f} ({n_vol} volume events)" if grid is not None else ""
    rk4 = f", {n_rk4} RK4 steps ({n_rk4 / n_rays:.4f} per ray)" if cfg.geodesic else ""
    per = ("per launch" if chunks == 1 else
           f"per call of {chunks} launches ({kernel_ms:.3f} ms per launch)")
    print(f"phase {phase}: {launch.__name__} alone median {call_ms:.3f} ms {per} (min "
          f"{call_lo:.3f}, max {call_hi:.3f}, {REPEATS} seeds"
          + (", each launch with its fold" if items else "") + f") at {W}x{H} {spp} spp, "
          f"{n_rays} rays (bound {bound_ms:.3f} ms by {bound_by}"
          + (f", one primitive test per segment; sweep floor {sweep_ms:.3f} ms" if bvh else "")
          + f"); {warp_stats(rays, iters)}, slowest block over the mean block "
          f"{block_tail(iters):.3f}{march}{rk4}; SM clock, power after it {clock}")
    bound_ms /= chunks
    if not items and not bvh:  # the surface lane loop: its waves, warps per SM, ptxas lines
        min_blocks, per_sm, sms = item_occupancy(cfg, table.numel(), counts)
        blocks = -(-pix.numel() // _build.TRACE_BLOCK)
        print(f"phase {phase}: one thread per lane: {blocks} blocks of {_build.TRACE_BLOCK}, "
              f"{per_sm} per SM ({per_sm * _build.TRACE_BLOCK // 32} warps) x {sms} SMs, "
              f"{blocks / (per_sm * sms):.2f} waves, minBlocks "
              f"{min_blocks}; ptxas of the surface instantiations: " + " | ".join(
                  ln for ln in ptxas_report(_build.build_log()) if "GEO=0,VOL=0" in ln))
    tests = None
    if bvh:  # an instrumented call: each lane's node and primitive tests
        lane_tests = torch.empty((2, pix.numel()), dtype=torch.int32, device=dev)
        call(REPEATS, bvh_tests=lane_tests)
        tests = [int(t.sum(dtype=torch.int64)) / n_rays for t in lane_tests]
        print(f"phase {phase}: BVH of {counts['n_node']} nodes and {counts['n_key']} keys, built "
              f"with the table in {table_s * 1e3:.1f} ms on the host; per segment "
              f"{tests[0]:.3f} node tests and {tests[1]:.3f} primitive tests of "
              f"{counts['n_sph'] + counts['n_rct'] + counts['n_box']} primitives")
    fold = None
    if items:
        item_rays, item_iters = item_counts[0].reshape(-1), item_counts[1].reshape(-1)
        lane_iters = item_counts[1].sum(dim=1, dtype=torch.int32)
        min_blocks, per_sm, sms = item_occupancy(cfg, table.numel(), counts)
        blk = _build.TRACE_BLOCK
        blocks = -(-item_iters.numel() // blk)
        if cfg.looped_masses:  # the pool's resident grid
            blocks = min(blocks, per_sm * sms)
        budget = (f"; {blocks} blocks of {blk}, {per_sm} per SM ({per_sm * blk // 32} warps) x "
                  f"{sms} SMs, minBlocks {min_blocks}")
        print(f"phase {phase}: one thread per (lane, sample): "
              f"{warp_stats(item_rays, item_iters, 'item')}, slowest block over the mean block "
              f"{block_tail(item_iters):.3f}; one thread per lane (the parent design, the same "
              f"paths): {warp_stats(item_counts[0].sum(dim=1), lane_iters)}, slowest block over "
              f"the mean block {block_tail(lane_iters):.3f}{budget}")
        if cfg.looped_masses:
            pool_use(phase, call, item_iters, blocks * blk, call_ms, dev)
        fold = fold_alone(phase, pix.numel(), spp, 10 if cfg.want_aovs else 3, cfg.max_iters(spp),
                          dev)
    kern_pass = make_render_pass(r.arrays, W, H, plain_rows, pass_spp, n, cfg, "full")
    (k_sums, k_rays), pass_ms, _, _ = cuda_ms_median(
        lambda i: kern_pass(r._cam_packed, seed + i, 0, 0), REPEATS)
    (k_sums, k_rays) = kern_pass(r._cam_packed, seed, 0, 0)
    (p_sums, p_rays), plain_ms = cuda_ms(
        lambda: render_pass(r.arrays, r.camera_params(cam), seed, 0, 0, W, H, plain_rows,
                            pass_spp, n, cfg, "full"))
    close = ((k_sums - p_sums).abs() <= ATOL + RTOL * p_sums.abs()).all(dim=-1)
    share = float(close.float().mean())
    mean_rel = abs(float(k_sums.mean()) - float(p_sums.mean())) / abs(float(p_sums.mean()))
    max_err = float((k_sums - p_sums).abs().max())
    print(f"phase {phase}: kernel vs plain pass at {W}x{plain_rows} rows, {pass_spp} spp: "
          f"pixels within tol {share:.6f}, image mean rel diff {mean_rel:.3e}, max |diff| "
          f"{max_err:.3e}, rays kernel {int(k_rays)} plain {int(p_rays)}; kernel pass "
          f"(tracer, accumulate) {pass_ms:.3f} ms, plain pass {plain_ms:.1f} ms")
    glue_ms = run["dt"] / 4 * 1e3 - call_ms
    print(f"phase {phase}: the main path's pass wall minus the kernel alone {glue_ms:.3f} ms "
          f"({run['dt'] / 4 * 1e3:.3f} - {call_ms:.3f}); host ms per pass "
          f"{run['host_s'] / 4 * 1e3:.3f}")
    acc = accumulate_alone(phase, res[0], res[1], n * n, H, W, dev, pix if tiled else None)
    if share < 0.999 or mean_rel > 1e-4:
        fail(f"kernel pass disagrees with the plain pass at {W}x{plain_rows}")
    if int(k_rays) != int(p_rays):
        fail(f"kernel pass and plain pass count different rays at {W}x{plain_rows}")
    if plain_ms > PLAIN_BUDGET_S * 1e3:
        print(f"phase {phase}: the plain pass took over {PLAIN_BUDGET_S:.0f} s: narrow "
              "its row band")
    return dict(kernel_ms=kernel_ms, kernel_ms_min=kernel_lo, kernel_ms_max=kernel_hi,
                call_ms=call_ms, chunks=chunks, pass_ms=pass_ms, plain_ms=plain_ms,
                max_err=max_err, bound_ms=bound_ms,
                bound_by=bound_by, rays=n_rays, vol_events=n_vol, rk4_steps=n_rk4,
                pass_spp=pass_spp, fold=fold, sweep_floor_ms=sweep_ms if bvh else None,
                tests=tests, table_ms=table_s * 1e3, glue_ms=glue_ms, accumulate=acc,
                occupancy=occupancy)


# phase 11's LOOPM call (256x256, 16 spp, each launch with its fold) with one
# item a thread, before the pool: median of 7 seeds, NVIDIA H100 80GB HBM3
# at 700.00 W (PERF.md §6, kernel 1e-iii)
LOOPM_ONE_ITEM_MS = 56.469


def pool_use(phase: int, call, item_iters, threads: int, call_ms: float, dev) -> None:
    """Phase 11: the LOOPM tracer's own warp-use count of one call at the
    key of ``item_iters`` (its items' iterations in item order), which must
    sum those iterations and issue a multiple of 32 no fewer; beside it
    the static count of one item a thread (``warp_use_plain``) and the pool
    model at the launch's ``threads`` (``warp_use_pool_plain``), and the
    call against the one-item-a-thread route's time."""
    import torch

    from bendy_tpu_torch.ops.trace_kernel import warp_use_plain, warp_use_pool_plain

    use = torch.zeros(2, dtype=torch.int64, device=dev)
    call(REPEATS, loop_use=use)
    static, model = (torch.zeros(2, dtype=torch.int64) for _ in range(2))
    warp_use_plain(item_iters.cpu(), static)
    warp_use_pool_plain(item_iters.cpu(), model, threads)
    got = use.tolist()
    print(f"phase {phase}: the item pool of {threads} threads: the tracer's count {got} "
          f"({100 * got[0] / max(got[1], 1):.2f} %), one item a thread {static.tolist()} "
          f"({100 * static[0] / static[1]:.2f} %), the pool model {model.tolist()} "
          f"({100 * model[0] / model[1]:.2f} %); the call {call_ms:.3f} ms against one item a "
          f"thread's {LOOPM_ONE_ITEM_MS} ms ({call_ms / LOOPM_ONE_ITEM_MS:.4f})")
    if got[0] != int(item_iters.sum()) or got[1] % 32 or got[1] < got[0]:
        fail("the LOOPM tracer's warp-use count disagrees with its items' iterations")


def accumulate_alone(phase: int, out, rays, nn: int, H: int, W: int, dev, pix=None) -> dict:
    """The accumulate kernel alone at a main path's shape, on the tracer's
    words of the kernel-alone call (FULL output) and, where they are
    tile-major, the lanes' pixel ids ``pix``: add mode into a seeded
    film, held bit for bit to its plain version, then timed on the device
    as 20 launches captured in a CUDA graph (:func:`graph_ms`, the median
    of 7 replays: a launch of a few microseconds is shorter than the
    host's launch overhead, which CUDA events around one call would time),
    beside the plain version and the parent's route, which it replaces
    (``pixel_sums`` of the TraceSums, ``+=`` into the film and the int64 ray
    sum: 6 kernels and 2 temporaries), timed the same way; each call's
    CUDA-event time (the median of REPEATS, host-bound) is printed too. The
    bound is bytes: three rows of lane words and the ray counts read once,
    the film read and written once."""
    import torch

    from bendy_tpu_torch.ops.trace_kernel import accumulate, accumulate_plain, pixel_sums
    from bendy_tpu_torch.ops.wavefront import TraceSums
    from bendy_tpu_torch.utils.v3 import V3

    film = torch.rand((H, W, 3), generator=torch.Generator(device=dev).manual_seed(29),
                      device=dev)
    got, want = film.clone(), film.clone()
    rk, rp = (torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(2))
    accumulate(out, rays, "full", nn, got, add=True, ray_total=rk, pix=pix)
    (_, plain_ms) = cuda_ms(lambda: accumulate_plain(out, rays, "full", nn, want, add=True,
                                                     ray_total=rp, pix=pix))
    equal = bool(torch.equal(got.view(torch.int32), want.view(torch.int32))) and \
        int(rk) == int(rp)
    err = float((got - want).abs().max())
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    res = TraceSums(V3(out[0], out[1], out[2]), None, None, None, zero, zero, zero)

    def kernel():
        accumulate(out, rays, "full", nn, got, add=True, ray_total=rk, pix=pix)

    def parent_route():
        got.add_(pixel_sums(res, "full", H, W, nn))  # DeviceFilm.add_pass's +=
        return rays.sum(dtype=torch.int64)

    ms, lo, hi = graph_ms(kernel)
    route_ms, _, _ = graph_ms(parent_route)
    _, call_ms, _, _ = cuda_ms_median(lambda i: kernel(), REPEATS)
    _, route_call_ms, _, _ = cuda_ms_median(lambda i: parent_route(), REPEATS)
    lanes = out.shape[1]
    ids = 0 if pix is None else H * W  # a tiled pixel's id, read once
    bound_ms = (4 * (3 * lanes + lanes + ids + 2 * H * W * 3) + 8) / PEAK_BYTES_S * 1e3
    print(f"phase {phase}: accumulate alone {ms:.4f} ms a launch on the device (20 launches "
          f"in a CUDA graph, median of 7 replays, min {lo:.4f}, max {hi:.4f}) at {H * W} pixels "
          f"x {nn} subpixels, add mode (bound "
          f"{bound_ms:.4f} ms by bytes); bit-equal to its plain version {equal}, plain "
          f"{plain_ms:.3f} ms; the parent's route (pixel_sums, +=, the int64 ray sum) "
          f"{route_ms:.4f} ms on the device; a call between CUDA events (host-bound, median of "
          f"{REPEATS}) {call_ms:.4f} ms, the parent's route {route_call_ms:.4f} ms")
    if not equal:
        fail("accumulate disagrees with its plain version at the main path's shape")
    return dict(ms=ms, ms_min=lo, ms_max=hi, plain_ms=plain_ms, bound_ms=bound_ms,
                library_ms=route_ms, max_err=err, call_ms=call_ms, route_call_ms=route_call_ms)


def fold_alone(phase: int, lanes: int, spp: int, n_out: int, cap: int, dev) -> dict:
    """The fold kernel alone at a main path's shape, in the chunks of
    samples the wrapper folds (``split_samples``: the first chunk from 0,
    each later one carrying the sums on): ``lanes`` x the chunk's samples
    of seeded random words (the fold's work does not depend on them), each
    chunk held bit for bit to its plain version (``fold_samples_plain``) on
    the running sums, then timed: the median and spread of REPEATS
    launches, the plain version's time and, as the library yardstick, the
    PyTorch sums over the chunk's samples of the words the fold reads, the
    sums' rows and the two counts' (``torch.sum``, which does not promise
    the order), timed as the fold is. Times and the bound are per launch,
    the mean over the chunks. The bound is bytes: every item word read once, every
    lane word written once (and read once more by a later chunk)."""
    import torch

    from bendy_tpu_torch.ops.trace_kernel import (N_COUNTS, fold_samples, fold_samples_plain,
                                                  split_samples)

    g = torch.Generator(device=dev).manual_seed(17)

    def outputs():
        return (torch.empty((n_out, lanes), device=dev),
                *torch.empty((2, lanes), dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))

    got, want, spare = outputs(), outputs(), outputs()

    def chunk(c0: int, s: int) -> dict:
        items = lanes * s
        samp = torch.randn((n_out, items), generator=g, device=dev) * 10.0 ** torch.randint(
            -6, 6, (n_out, items), generator=g, device=dev)
        cnt = torch.randint(0, 300, (N_COUNTS, items), generator=g, device=dev,
                            dtype=torch.int32)
        kw = dict(first=c0 == 0, max_iters=cap if c0 + s == spp else -1)
        fold_samples(samp, cnt, s, *got[:3], over_cap=got[3], **kw)
        _, plain_ms = cuda_ms(lambda: fold_samples_plain(samp, cnt, s, *want[:3],
                                                         over_cap=want[3], **kw))
        equal = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(got, want))
        _, ms, lo, hi = cuda_ms_median(
            lambda i: fold_samples(samp, cnt, s, *spare[:3], first=kw["first"]), REPEATS)
        _, library_ms, _, _ = cuda_ms_median(
            lambda i: (samp.view(n_out, lanes, s).sum(dim=2),
                       cnt[:2].view(2, lanes, s).sum(dim=2, dtype=torch.int32)), REPEATS)
        nbytes = 4 * (n_out + 2) * (items + lanes * (1 if c0 == 0 else 2))
        return dict(s=s, equal=equal, err=float((got[0] - want[0]).abs().max()), ms=ms, lo=lo,
                    hi=hi, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=nbytes / PEAK_BYTES_S * 1e3)

    sc = split_samples(lanes, spp, n_out)
    runs = [chunk(c0, min(sc, spp - c0)) for c0 in range(0, spp, sc)]

    def mean(k):
        return sum(r[k] for r in runs) / len(runs)

    equal, err = all(r["equal"] for r in runs), max(r["err"] for r in runs)
    ms, lo, hi = mean("ms"), min(r["lo"] for r in runs), max(r["hi"] for r in runs)
    print(f"phase {phase}: fold_samples alone median {ms:.4f} ms per launch (min {lo:.4f}, max "
          f"{hi:.4f}) at {lanes} lanes x {spp} samples in {len(runs)} launch(es) of "
          f"{'+'.join(str(r['s']) for r in runs)} samples ({sum(r['ms'] for r in runs):.4f} ms "
          f"in all), {n_out} sums and 2 counts (bound {mean('bound_ms'):.4f} ms per launch by "
          f"bytes); bit-equal to its plain version {equal} (max |diff| {err:.3e}), plain "
          f"{mean('plain_ms'):.3f} ms, torch.sum over the samples {mean('library_ms'):.4f} ms "
          f"per launch; by chunk: " + ", ".join(
              f"{r['s']} samples {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, torch.sum "
              f"{r['library_ms']:.4f})" for r in runs))
    if not equal:
        fail("fold_samples disagrees with its plain version")
    return dict(ms=ms, ms_min=lo, ms_max=hi, plain_ms=mean("plain_ms"), max_err=err,
                bound_ms=mean("bound_ms"), library_ms=mean("library_ms"), launches=len(runs))


# (phase, scene, Config kwargs, width, height, spp, subsample, wrapper name,
#  spp and rows of the kernel pass and the plain pass, the TPU kernel it
#  replaces)
PALLAS = "bendy_tpu/ops/pallas_trace.py:255"
MAIN_PATHS = [
    (4, "cornell", {}, 256, 256, 64, 2, "trace_surface", 64, 256, PALLAS),
    (5, "blackhole", dict(max_bounces=2), 512, 512, 32, 1, "trace_geodesic", 4, 512,
     f"{PALLAS} (1d: geodesic)"),
    (6, "cloud", {}, 256, 256, 64, 2, "trace_volume", 4, 256,
     f"{PALLAS} (1b: baked sparse grid, bendy_tpu/ops/volume.py:182)"),
    (7, "dense_cloud", {}, 256, 256, 64, 2, "trace_volume", 4, 256,
     f"{PALLAS} (1c: dense-grid brick fetch, bendy_tpu/ops/volume.py:248)"),
    (8, "blackhole_cloud", dict(max_bounces=2, volume_step=0.6), 512, 288, 32, 1,
     "trace_volume", 4, 288, f"{PALLAS} (1b+1d: sparse grid under geodesics)"),
    (9, "prim_grid_256", dict(max_bounces=4), 256, 256, 16, 1, "trace_surface", 4, 256,
     f"{PALLAS} (1e-i: looped primitive sweep, bendy_tpu/ops/intersect.py:740)"),
    (10, "cloud_field", dict(max_bounces=4), 256, 256, 16, 1, "trace_volume", 4, 256,
     f"{PALLAS} (1e-i with 1b: looped primitive sweep in media, "
     "bendy_tpu/ops/intersect.py:740)"),
    (11, "mass_cluster", dict(max_bounces=2), 256, 256, 16, 1, "trace_geodesic", 4, 256,
     f"{PALLAS} (1e-iii: looped mass sweep, bendy_tpu/geodesic.py:236,309,349)"),
    (12, "light_field_200", dict(max_bounces=3), 256, 256, 16, 1, "trace_surface", 4, 256,
     f"{PALLAS} (1e-ii: looped light sweep, bendy_tpu/ops/materials.py:132, "
     "bendy_tpu/ops/intersect.py:1183)"),
]


SMOKE_DIR = "smoke_out"  # git-ignored scratch of phases 13-14
MESH_TIMEOUT_S = 300.0
# the spawned 2x2 passes of phase 13(b): (scene, Config kwargs, W, H, spp, subsample)
MESH_CASES = [("cornell", {}, 256, 256, 64, 2),
              ("blackhole_cloud", dict(max_bounces=2, volume_step=0.6), 64, 64, 4, 1),
              ("mass_cluster", dict(max_bounces=2), 64, 64, 4, 1)]
MESH_RTOL = MESH_ATOL = 2e-5  # tests/test_parallel.py:52: the samples axis sums in another order


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    from bendy_tpu_torch.ops import trace_kernel
    from bendy_tpu_torch.parallel import mesh
    from bendy_tpu_torch.tools import mxu_shape_probe, vpu_peak

    for fn in (trace_kernel.trace_surface, trace_kernel.trace_geodesic,
               trace_kernel.trace_volume, trace_kernel.fold_samples, trace_kernel.accumulate,
               mesh.make_kernel_pass_sharded, vpu_peak.fp32_chain, mxu_shape_probe.bf16_dot_chain):
        fn.launches = 0


def sharded_pass(dev) -> dict:
    """Phase 13: the sharded pass on the card. (a) cornell 256x256, 64 spp,
    2x2 subpixels, default Config on a (1,1) mesh, an NCCL world of one in
    this process: a warm-up pass, then 4 chained passes with fresh seeds
    (bench.py's sharded row), the film bit-equal to the Renderer's pass at
    the same seed; the kernel pass alone, and the plain sharded pass at spp
    4. (b) 2x2 meshes of 4 spawned gloo ranks on this card, each film
    against the unsharded kernel pass (rtol/atol 2e-5, equal int64 rays)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from bendy_tpu_torch import Config, DeviceFilm, RenderConfig, Subsample
    from bendy_tpu_torch.ops.trace_kernel import (accumulate, fold_samples, make_render_pass,
                                                  scene_table, trace_surface)
    from bendy_tpu_torch.parallel import (initialize, make_kernel_pass_sharded, make_mesh,
                                          render_pass_sharded, render_scene_pass, spawn)
    from bendy_tpu_torch.parallel.multihost import free_port

    W = H = 256
    spp, n = 64, 2
    backend = initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl", device="cuda",
                         timeout_s=MESH_TIMEOUT_S)
    try:
        mesh = make_mesh(1, 1, "cuda")
        r, cam = renderer("cornell", Config(), W, H, dev)
        r.camera_params(cam)
        cfg = r.trace_config(r.config, cam)
        fn = make_kernel_pass_sharded(r.arrays, mesh, W, H, spp, n, cfg, "full")
        base = int.from_bytes(os.urandom(4), "little") & 0x7FFFFFF
        fn(r._cam_packed, base, 0)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        total, ray_parts = None, []
        for p in range(4):  # chained passes, fresh seeds
            s, ry = fn(r._cam_packed, base + 1 + p, p)
            total = s if total is None else total + s
            ray_parts.append(ry)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, surface_launches = make_kernel_pass_sharded.launches, trace_surface.launches
        folds, accs = fold_samples.launches, accumulate.launches
        rays = int(torch.stack(ray_parts).sum())
        print(f"phase 13: (a) {backend} world of 1, (1,1) mesh, cornell {W}x{H} {spp} spp "
              f"{n}x{n}: 4 passes in {dt:.4f} s, {dt / 4:.4f} s/pass, {rays} rays, "
              f"{rays / dt / 1e6:.1f} Mrays/s, make_kernel_pass_sharded launches {launches}, "
              f"trace_surface launches {surface_launches}, fold_samples launches {folds}, "
              f"accumulate launches {accs}")
        if launches != 4 or surface_launches != 4 or folds != 0 or accs != 4:
            fail("the sharded main path did not launch its kernel and the accumulate once per "
                 "pass, without a fold")
        if not bool(torch.isfinite(total).all()) or float(total.mean()) <= 0:
            fail("the sharded cornell film is not finite and non-zero")
        seed = base + 1
        sums, s_rays = fn(r._cam_packed, seed, 0)
        film = DeviceFilm(W, H, device=dev)
        r.rays_traced = 0
        r.render(cam, RenderConfig(samples=spp, subsample=Subsample(n)), film, seed=seed)
        equal = bool(torch.equal(sums, film.sum)) and int(s_rays) == r.rays_traced
        print(f"phase 13: (a) sharded pass vs the Renderer's pass at seed {seed}: bit-equal "
              f"{equal}, rays {int(s_rays)} vs {r.rays_traced}")
        if not equal:
            fail("the (1,1) sharded pass is not bit-equal to the unsharded pass")
        (k_sums, k_rays), kernel_ms = cuda_ms(lambda: fn(r._cam_packed, seed, 0), 10, 1,
                                              warm_s=0.5)
        clock = sm_clock()
        table_np, counts = scene_table(r.arrays.host_copy())
        bound_ms, bound_by = trace_bound(counts, table_np.size, cfg, int(k_rays), W * H * n * n,
                                         W * H * n * n * spp,
                                         rows=sweeps_rows(cfg, table_np.size, counts))
        pass_spp = 4
        fn4 = make_kernel_pass_sharded(r.arrays, mesh, W, H, pass_spp, n, cfg, "full")
        k4, k4_rays = fn4(r._cam_packed, seed, 0)
        (p4, p4_rays), plain_ms = cuda_ms(lambda: render_pass_sharded(
            r.arrays, r.camera_params(cam), seed, 0, mesh, W, H, pass_spp, n, cfg, "full"))
        close = ((k4 - p4).abs() <= ATOL + RTOL * p4.abs()).all(dim=-1)
        share = float(close.float().mean())
        max_err = float((k4 - p4).abs().max())
        print(f"phase 13: (a) the sharded pass alone {kernel_ms:.3f} ms (bound {bound_ms:.3f} ms "
              f"by {bound_by}); SM clock, power after it {clock}; kernel vs plain sharded pass "
              f"at {pass_spp} spp: pixels within tol {share:.6f}, max |diff| {max_err:.3e}, "
              f"rays {int(k4_rays)} vs {int(p4_rays)}, plain {plain_ms:.1f} ms")
        if share < 0.999 or int(k4_rays) != int(p4_rays):
            fail("the sharded kernel pass disagrees with the plain sharded pass")
    finally:
        dist.destroy_process_group()

    os.makedirs(SMOKE_DIR, exist_ok=True)
    for name, kw, w, h, s, sub in MESH_CASES:
        out = os.path.join(SMOKE_DIR, f"mesh_{name}.npz")
        if os.path.exists(out):
            os.remove(out)
        t0 = time.perf_counter()
        spawn(render_scene_pass, 2, 2, device="cuda", backend="gloo",
              timeout_s=MESH_TIMEOUT_S,
              args=(f"scenes/{name}.json.gz", Config(**kw), w, h, s, sub, 7, 0, out))
        wall = time.perf_counter() - t0
        z = np.load(out)
        rr, rcam = renderer(name, Config(**kw), w, h, dev)
        rr.camera_params(rcam)
        one, one_rays = make_render_pass(rr.arrays, w, h, h, s, sub,
                                         rr.trace_config(rr.config, rcam), "full")(
            rr._cam_packed, 7, 0, 0)
        one = one.cpu().numpy()
        ok = np.allclose(z["sums"], one, rtol=MESH_RTOL, atol=MESH_ATOL)
        err = float(np.abs(z["sums"] - one).max())
        print(f"phase 13: (b) 2x2 gloo mesh on one card, {name} {w}x{h} {s} spp {sub}x{sub}: "
              f"within rtol/atol {MESH_RTOL:g} {ok}, max |diff| {err:.3e}, rays {int(z['rays'])} "
              f"vs {int(one_rays)}; rank 0's pass {float(z['seconds']):.2f} s, spawn and join "
              f"{wall:.1f} s")
        if not ok or int(z["rays"]) != int(one_rays):
            fail(f"the 2x2 sharded {name} film disagrees with the unsharded kernel pass")
    return dict(kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                launches=launches, max_err=max_err, rays=rays, dt=dt, pass_spp=pass_spp)


def mesh_on_cards() -> int:
    """The sharded pass across 4 cards (not part of ``run``, which needs one
    card): 2x2 meshes of 4 spawned NCCL ranks, one card each, on
    MESH_CASES after a warm-up pass, each film within rtol/atol 2e-5 of the
    unsharded kernel pass on card 0 (timed alone with CUDA events beside
    it), then the CLI's --mesh 2x2 on cornell. Run as
        python3 -c "import chip_smoke as c, sys; sys.exit(c.mesh_on_cards())"
    """
    import numpy as np
    import torch

    from bendy_tpu_torch import Config
    from bendy_tpu_torch.ops.trace_kernel import make_render_pass
    from bendy_tpu_torch.parallel import render_scene_pass, spawn

    cards = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"mesh on cards: {cards} card(s): {' | '.join(smi.splitlines())}")
    if cards < 4:
        fail(f"the 2x2 NCCL mesh needs 4 cards, found {cards}")
    dev = torch.device("cuda", 0)
    os.makedirs(SMOKE_DIR, exist_ok=True)
    for name, kw, w, h, s, sub in MESH_CASES:
        out = os.path.join(SMOKE_DIR, f"mesh4_{name}.npz")
        t0 = time.perf_counter()
        spawn(render_scene_pass, 2, 2, device="cuda", timeout_s=MESH_TIMEOUT_S,
              args=(f"scenes/{name}.json.gz", Config(**kw), w, h, s, sub, 7, 0, out, True))
        wall = time.perf_counter() - t0
        z = np.load(out)
        rr, rcam = renderer(name, Config(**kw), w, h, dev)
        rr.camera_params(rcam)
        one_pass = make_render_pass(rr.arrays, w, h, h, s, sub, rr.trace_config(rr.config, rcam),
                                    "full")
        (one, one_rays), one_ms = cuda_ms(lambda: one_pass(rr._cam_packed, 7, 0, 0), 5, 1,
                                          warm_s=0.5)
        one = one.cpu().numpy()
        ok = np.allclose(z["sums"], one, rtol=MESH_RTOL, atol=MESH_ATOL)
        print(f"mesh on cards: 2x2 nccl, {name} {w}x{h} {s} spp {sub}x{sub}: within rtol/atol "
              f"{MESH_RTOL:g} {ok}, max |diff| {float(np.abs(z['sums'] - one).max()):.3e}, rays "
              f"{int(z['rays'])} vs {int(one_rays)}; rank 0's warm pass and gather "
              f"{float(z['seconds']) * 1e3:.3f} ms against {one_ms:.3f} ms for the unsharded "
              f"pass on one card; spawn and join {wall:.1f} s")
        if not ok or int(z["rays"]) != int(one_rays):
            fail(f"the 2x2 NCCL {name} film disagrees with the unsharded kernel pass")
    proc = subprocess.run(
        [sys.executable, "-m", "bendy_tpu_torch.cli", "--scene", "scenes/cornell.json.gz",
         "--width", "256", "--height", "256", "--samples", "64", "--subsample", "2",
         "--mesh", "2x2", "--screenshot", os.path.join(SMOKE_DIR, "mesh4.png")],
        capture_output=True, text=True, timeout=600)
    line = [ln for ln in proc.stderr.splitlines() if ln.startswith("mesh 2x2:")]
    print(f"mesh on cards: CLI --mesh 2x2 exit {proc.returncode}: "
          f"{line[0] if line else proc.stderr[-2000:]}")
    if proc.returncode != 0 or not line:
        fail("the CLI --mesh 2x2 failed on 4 cards")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cards}}))
    return 0


def cli_on_card(dev) -> None:
    """Phase 14: the port's CLI in a subprocess at cornell's main-path size,
    its checkpoint bit-equal to the same passes through the Renderer here;
    then --mesh 1x1."""
    import numpy as np

    from bendy_tpu_torch import Config, DeviceFilm, Film, RenderConfig, Subsample

    os.makedirs(SMOKE_DIR, exist_ok=True)
    ckpt = os.path.join(SMOKE_DIR, "cli.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    seed = 11
    base = [sys.executable, "-m", "bendy_tpu_torch.cli", "--scene", "scenes/cornell.json.gz",
            "--width", "256", "--height", "256", "--samples", "64", "--subsample", "2",
            "--spp-per-pass", "16", "--seed", str(seed),
            "--screenshot", os.path.join(SMOKE_DIR, "cli.png")]
    t0 = time.perf_counter()
    proc = subprocess.run(base + ["--checkpoint", ckpt], capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    total = [ln for ln in proc.stderr.splitlines() if ln.startswith("total t:")]
    print(f"phase 14: CLI exit {proc.returncode} in {wall:.1f} s: "
          f"{total[0] if total else 'no telemetry line'}")
    if proc.returncode != 0:
        fail(f"the CLI failed:\n{proc.stdout}\n{proc.stderr}")
    film, _ = Film.load_checkpoint(ckpt)
    r, cam = renderer("cornell", Config(), 256, 256, dev)
    mine = DeviceFilm(256, 256, device=dev)
    while mine.samples < 64 * 4:
        r.render(cam, RenderConfig(samples=16, subsample=Subsample(2)), mine, seed=seed)
    equal = (film.passes, film.samples) == (mine.passes, mine.samples) and \
        np.array_equal(film.sum, mine._host_sum())
    print(f"phase 14: CLI checkpoint ({film.passes} passes, {film.samples} samples) bit-equal "
          f"to the Renderer's passes here: {equal}")
    if not equal:
        fail("the CLI's film differs from the in-process Renderer's")
    t0 = time.perf_counter()
    proc = subprocess.run(base + ["--mesh", "1x1"], capture_output=True, text=True, timeout=600)
    line = [ln for ln in proc.stderr.splitlines() if ln.startswith("mesh 1x1:")]
    print(f"phase 14: CLI --mesh 1x1 exit {proc.returncode} in {time.perf_counter() - t0:.1f} s: "
          f"{line[0] if line else 'no mesh line'}")
    if proc.returncode != 0 or not line or "Mrays/s" not in line[0]:
        fail(f"the CLI --mesh 1x1 failed:\n{proc.stdout}\n{proc.stderr}")


SASS_DOT_OPS = ("HGMMA", "F2FP", "FADD", "LDS", "LDG")


def sass_counts() -> dict:
    """FFMA / FADD counts in the SASS of the two FP32-chain instantiations,
    and for each dot-chain instantiation the HGMMA, F2FP, FADD, LDS and LDG
    of its innermost loop that holds an HGMMA and the HGMMA of the whole
    function (``cuobjdump -sass`` of the library, read by
    tools/sweep_sass.py's listing parser)."""
    from bendy_tpu_torch import _build
    from bendy_tpu_torch.tools import sweep_sass

    def ops(texts) -> Counter:
        return Counter(sweep_sass.opcode(t).split(".")[0] for t in texts)

    out = {}
    listing = sweep_sass.library_listing(_build.build()[0])
    for name, text in sweep_sass.functions(listing).items():
        ins, labels = sweep_sass.instructions(text)
        every = ops(t for _, t in ins)
        for tag, label in (("fp32_chain_kernelILb1E", "fma"), ("fp32_chain_kernelILb0E", "nofma")):
            if tag in name:
                out[label] = {op: every[op] for op in ("FFMA", "FADD")}
        d = re.search(r"bf16_dot_chain_kernelILi(\d+)ELi(\d+)E", name)
        if d:
            bodies = [[ins[i][1] for i in idx] for idx, _ in sweep_sass.loops(ins, labels)]
            bodies = [b for b in bodies if ops(b)["HGMMA"]]
            loop = min(bodies, key=len) if bodies else []
            counts = {op: ops(loop)[op] for op in SASS_DOT_OPS}
            counts.update(loop_instructions=len(loop), function_HGMMA=every["HGMMA"])
            out[f"dot BN={d.group(1)} KS={d.group(2)}"] = counts
    return out


def probes(dev) -> list:
    """Phase 15: the two ceiling probes, each held against its plain version
    at a small iteration count, then measured through their entry points."""
    import numpy as np
    import torch

    from bendy_tpu_torch.tools import mxu_shape_probe as mxu
    from bendy_tpu_torch.tools import vpu_peak as vpu

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain dot in full f32
    counts = sass_counts()
    print(f"phase 15: SASS of the FP32 chains: "
          f"{ {k: v for k, v in counts.items() if k in ('fma', 'nofma')} }")
    print(f"phase 15: SASS of the dot chain's loop (2 iterations, unrolled; {SASS_DOT_OPS}): "
          f"{ {k: v for k, v in counts.items() if k.startswith('dot')} }")
    if (counts.get("fma", {}).get("FFMA", 0) < 32
            or counts.get("nofma", {}).get("FADD", 0) < 64):
        fail("the FP32 chain's loop does not hold the FFMA / FADD it should")
    if not all(v["function_HGMMA"] and v["HGMMA"] for k, v in counts.items()
               if k.startswith("dot")):
        fail("a dot-chain instantiation holds no HGMMA, or no loop that holds one")
    if not any(k.startswith("dot") for k in counts):
        fail("no dot-chain instantiation in the SASS")
    plain_iters = 16
    x = vpu.probe_input(vpu.ROWS, dev)
    check = {}
    for kind in ("fma", "nofma"):
        got = vpu.fp32_chain(x, kind, plain_iters)
        want, p_ms = cuda_ms(lambda: vpu.fp32_chain_plain(x, kind, plain_iters))
        _, k_ms = cuda_ms(lambda: vpu.fp32_chain(x, kind, plain_iters), 10)
        err = float((got - want).abs().max())
        ok = bool(torch.allclose(got, want, rtol=1e-5, atol=0))
        check[kind] = dict(err=err, plain_ms=p_ms, kernel_ms=k_ms)
        print(f"phase 15: fp32_chain {kind} vs plain at {vpu.ROWS}x128, {plain_iters} iters: "
              f"within rtol 1e-5 {ok}, max |diff| {err:.3e}; kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.1f} ms")
        if not ok:
            fail(f"fp32_chain {kind} disagrees with its plain version")
    rng = np.random.default_rng(3)
    dot_err = 0.0
    # the measured widths and odd multiples of 64, so each of the four tiles the plan
    # can take (256 x 16 / 32 / 64 at n 1024, 2048, 4096 and 8192; 64 x 64 at 64, 128,
    # 320, 1088), the f32 control, random inputs
    for n, dtype_name, random in ((64, "bf16", False), (128, "bf16", False),
                                  (320, "bf16", False), (1024, "bf16", False),
                                  (1088, "bf16", False), (2048, "bf16", False),
                                  (4096, "bf16", False), (8192, "bf16", False),
                                  (2048, "f32", False), (1024, "bf16", True),
                                  (1024, "f32", True), (1088, "bf16", True),
                                  (128, "f32", True), (2048, "bf16", True)):
        tab, oh = mxu.probe_inputs(n, dtype_name, dev)
        if random:  # small values whose bf16 rounding the perturbation moves; one-hot columns
            tab = torch.from_numpy(rng.integers(1, 64, (mxu.M, mxu.K)).astype(np.float32)
                                   * np.float32(2**-14)).to(dev, tab.dtype)
            oh = torch.from_numpy(np.eye(mxu.K, dtype=np.float32)[rng.integers(0, mxu.K, n)].T
                                  .copy()).to(dev, oh.dtype)
        got = mxu.bf16_dot_chain(tab, oh, 4)
        want = mxu.bf16_dot_chain_plain(tab, oh, 4)
        equal = bool(torch.equal(got, want))
        dot_err = max(dot_err, float((got - want).abs().max()))
        lib = ""
        if random:  # the yardstick computes the same sum, eagerly and as a graph replay
            replay, _ = mxu.library_graph(tab, oh, 4, 3)
            lib_equal = bool(torch.equal(mxu.library_dot_chain(tab, oh, 4, 3), want)) and \
                bool(torch.equal(replay(), want))
            equal = equal and lib_equal
            lib = f", cuBLAS yardstick (eager and graph) equal {lib_equal}"
        plan = mxu.dot_plan(n)
        print(f"phase 15: bf16_dot_chain n {n} {dtype_name}{' random' if random else ''} "
              f"(tile {plan.bn} x {plan.ks}, {plan.blocks} blocks) vs plain at 4 iters: "
              f"equal {equal}{lib}")
        if not equal:
            fail(f"bf16_dot_chain or its yardstick disagrees with the plain version at n {n} "
                 f"{dtype_name}")
    tab, oh = mxu.probe_inputs(2048, "bf16", dev)
    dot_plain_iters = 64
    _, dot_plain_ms = cuda_ms(lambda: mxu.bf16_dot_chain_plain(tab, oh, dot_plain_iters))
    _, dot_kernel_ms_small = cuda_ms(lambda: mxu.bf16_dot_chain(tab, oh, dot_plain_iters), 10)

    reset_launches()
    fma = vpu.measure("fma")
    nofma = vpu.measure("nofma")
    fp32_launches = vpu.fp32_chain.launches
    for m in (fma, nofma):
        print(f"phase 15: fp32_chain {m['kind']}: {m['ops_per_s']:.4e} ops/s median of 5 "
              f"launches of {m['ms']:.2f} ms ({m['iters']} iters x {m['rows']}x128), best "
              f"{m['ops_per_s_best']:.4e}, {m['share_of_peak']:.4f} of "
              f"{vpu.peak(m['kind']):.3g} ({vpu.PEAK_CLOCK_MHZ} MHz), "
              f"{m['share_at_clock'] or float('nan'):.4f} of the peak at the SM clock during the launches, "
              f"{m['sm_clock']} (power {m['power_draw']}, {m['clock_samples']} samples); after "
              f"them {m['sm_clock_after']}, {m['power_draw_after']}")
    print(f"phase 15: fusion ratio fma/nofma {fma['ops_per_s'] / nofma['ops_per_s']:.4f}")
    dots = {}
    for n in (1024, 2048, 4096, 8192):
        dots[n] = mxu.measure(n)
    dots["f32"] = mxu.measure(2048, dtype_name="f32", library=False)
    dot_launches = mxu.bf16_dot_chain.launches
    for key, m in dots.items():
        lib = (f"; cuBLAS {m['library_ms']:.3f} ms ({m['library_flops_per_s']:.4e} FLOP/s, "
               f"{mxu.LIBRARY_FORM}, {m['library_chunk']} iterations per product; ms by "
               f"chunk {m['library_ms_by_chunk']})" if "library_ms" in m else "")
        print(f"phase 15: bf16_dot_chain n {m['n']} {m['dtype']} (tile {m['bn']} x {m['ks']}, "
              f"{m['blocks']} blocks): {m['flops_per_s']:.4e} FLOP/s ({m['share_of_peak']:.4f} "
              f"of {mxu.PEAK_BF16_S:.3g}), {m['ms']:.3f} ms per launch of {m['iters']} "
              f"iters{lib}; during the launches SM clock {m['sm_clock']}, power "
              f"{m['power_draw']} ({m['clock_samples']} samples), after them "
              f"{m['sm_clock_after']}, {m['power_draw_after']}")
    print(f"phase 15: launches fp32_chain {fp32_launches}, bf16_dot_chain {dot_launches}")
    if fp32_launches < 10 or dot_launches < 25:
        fail("the probes' entry points did not launch their kernels")

    def probe_bound(ops, peak, nbytes):
        t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    fb, fb_by = probe_bound(vpu.ops(fma["rows"], fma["iters"]), vpu.PEAK_F32_S,
                            fma["rows"] * 128 * 8)
    d = dots[2048]
    db, db_by = probe_bound(mxu.flops(2048, d["iters"]), mxu.PEAK_BF16_S,
                            2 * (mxu.M * mxu.K + mxu.K * 2048) + 4 * mxu.M * 2048)
    return [
        {"name": "fp32_chain", "route": "cuda", "source": "bendy_tpu_torch/csrc/probes.cu",
         "replaces": "tools/vpu_peak.py:85", "launches": fp32_launches,
         "max_abs_err": max(c["err"] for c in check.values()), "ms": fma["ms"],
         "plain_ms": check["fma"]["plain_ms"], "bound_ms": fb, "bound_by": fb_by,
         "library_ms": None, "kind": "fma", "rows": fma["rows"], "iters": fma["iters"],
         "plain_iters": plain_iters, "kernel_ms_at_plain_iters": check["fma"]["kernel_ms"],
         "fma_ops_per_s": fma["ops_per_s"], "nofma_ops_per_s": nofma["ops_per_s"],
         "nofma_ms": nofma["ms"], "fusion_ratio": fma["ops_per_s"] / nofma["ops_per_s"],
         "fma_share_of_peak": fma["share_of_peak"],
         "nofma_share_of_peak": nofma["share_of_peak"],
         "sm_clock": fma["sm_clock"], "nofma_sm_clock": nofma["sm_clock"],
         "fma_share_at_clock": fma["share_at_clock"],
         "nofma_share_at_clock": nofma["share_at_clock"],
         "sass": {k: v for k, v in counts.items() if k in ("fma", "nofma")}},
        {"name": "bf16_dot_chain", "route": "cuda", "source": "bendy_tpu_torch/csrc/probes.cu",
         "replaces": "tools/mxu_shape_probe.py:110", "launches": dot_launches,
         "max_abs_err": dot_err, "ms": d["ms"], "plain_ms": dot_plain_ms, "bound_ms": db,
         "bound_by": db_by, "library_ms": d["library_ms"], "n": 2048, "iters": d["iters"],
         "plain_iters": dot_plain_iters, "kernel_ms_at_plain_iters": dot_kernel_ms_small,
         "library_form": mxu.LIBRARY_FORM, "library_chunk": d["library_chunk"],
         "flops_per_s": {str(k): m["flops_per_s"] for k, m in dots.items()},
         "share_of_peak": {str(k): m["share_of_peak"] for k, m in dots.items()},
         "library_ms_by_n": {str(k): m.get("library_ms") for k, m in dots.items()},
         "ms_by_n": {str(k): m["ms"] for k, m in dots.items()},
         "iters_by_n": {str(k): m["iters"] for k, m in dots.items()},
         "sm_clock_by_n": {str(k): m["sm_clock"] for k, m in dots.items()},
         "power_draw_by_n": {str(k): m["power_draw"] for k, m in dots.items()},
         "tile_by_n": {str(k): [m["bn"], m["ks"]] for k, m in dots.items()},
         "sass": {k: v for k, v in counts.items() if k.startswith("dot")}},
    ]


# each bench row (bendy_tpu_torch/bench.py --full) and the main path whose
# kernel entry it joins: the phase of the same tracer, scene class and shape
BENCH_PATH = {
    "cornell": "cornell", "cornell2": "cornell", "scene": "cornell", "volume": "cloud",
    "cloud": "cloud", "dense_cloud": "dense_cloud", "blackhole_geodesic": "blackhole",
    "blackhole_cloud": "blackhole_cloud", "prim_grid_256_looped": "prim_grid_256",
    "cloud_field_256_looped": "cloud_field", "mass_cluster_64_looped": "mass_cluster",
    "kernel_sharded_1x1": "sharded", "blackhole_1080p_256spp": "blackhole",
}
HEADLINE_BAND = 0.25  # the headline median against phase 4's Mrays/s, relative
UTILIZATION_ROW = "vpu_utilization_cornell"  # tools/perf_report.report("cornell")
UTILIZATION_SHARES = ("fp32_utilization_lo", "fp32_utilization_hi", "fp32_util_vs_measured_peak")


def utilization_ok(row: dict) -> bool:
    """A perf_report row's shares lie in (0, 1] and its rates are finite
    and positive (a share above 1 means the count or the rate is wrong)."""
    import math

    rates = ("ops_per_lane_iter", "sustained_ops_per_sec", "mrays_per_sec", "occupancy")
    return (all(0.0 < row.get(k, -1.0) <= 1.0 for k in UTILIZATION_SHARES)
            and all(math.isfinite(row.get(k, math.nan)) and row[k] > 0 for k in rates))


def bench_phase(paths: dict) -> dict:
    """Phase 16: ``python3 -m bendy_tpu_torch.bench --full`` in this
    process, into ``smoke_out/benches_results_torch.json``; it prints the
    headline JSON line. Fails unless every reference row is there, each
    scene row with a finite Mrays/s above 0, its
    tracer launched its kernel in every timed pass (the launch counts the
    row records, as main_path reads them; the sharded row: the pass, the
    tracer and the accumulate 12 times), the headline's cornell median lies
    within HEADLINE_BAND of phase 4's Mrays/s, each row's occupancy is
    the number phases 4-12 printed for the same path (scene and shape) at
    the same seed, and the ``vpu_utilization_cornell`` row
    (``tools/perf_report``) passes :func:`utilization_ok`.
    ``paths``: {main path name: (Mrays/s, occupancy)} of the phases run.
    Returns the rows."""
    import math

    from bendy_tpu_torch import bench

    os.makedirs(SMOKE_DIR, exist_ok=True)
    out = os.path.join(SMOKE_DIR, "benches_results_torch.json")
    t0 = time.perf_counter()
    bench.main(["--full", "--out", out])
    secs = time.perf_counter() - t0
    with open(out) as f:
        rows = json.load(f)
    bad = sorted(set(BENCH_PATH) ^ (set(rows) - {"_meta", UTILIZATION_ROW}))
    util = rows.get(UTILIZATION_ROW, {})
    print(f"phase 16: {UTILIZATION_ROW}: " + ", ".join(
        f"{k} {util.get(k)!r}" for k in ("ops_per_lane_iter", "occupancy", "mrays_per_sec",
                                         "sustained_ops_per_sec", *UTILIZATION_SHARES)))
    if not utilization_ok(util):
        bad.append(UTILIZATION_ROW)
    for name in BENCH_PATH:
        r = rows.get(name, {})
        mrays, launches, tracer = r.get("mrays"), r.get("launches", {}), r.get("tracer")
        wl = r.get("workload", {})
        timed = wl.get("passes_per_timing", 0) * wl.get("repeats", 0)
        ok = mrays is not None and math.isfinite(mrays) and mrays > 0
        if name == "kernel_sharded_1x1":
            ok = ok and launches.get("make_kernel_pass_sharded") == timed and \
                launches.get(tracer) == timed and launches.get("accumulate") == timed
        else:
            folds = launches.get("fold_samples")
            ok = ok and launches.get(tracer, 0) >= timed > 0 and \
                launches.get("accumulate", 0) >= timed and \
                folds in (0, launches.get(tracer))
        path = BENCH_PATH[name]
        occ = ""
        if "occupancy" in r and path in paths and wl["scene"].split(" ")[0] == path:
            same = r["occupancy"] == paths[path][1] and r["occupancy_seed"] == \
                bench.OCCUPANCY_SEED
            ok = ok and same
            occ = (f", occupancy {r['occupancy']!r} (phase's {paths[path][1]!r}, seed "
                   f"{r['occupancy_seed']}: equal {same})")
        print(f"phase 16: {name}: {mrays} Mrays/s median, {r.get('seconds')} s a pass, tracer "
              f"alone {r.get('kernel_ms')} ms, {tracer} launches {launches}{occ}")
        if not ok:
            bad.append(name)
    head = rows.get("cornell", {}).get("mrays")
    if "cornell" in paths and head:
        off = head / paths["cornell"][0] - 1.0
        print(f"phase 16: headline cornell median {head} Mrays/s against phase 4's "
              f"{paths['cornell'][0]} Mrays/s: {off:+.4f} (band +-{HEADLINE_BAND})")
        if abs(off) > HEADLINE_BAND:
            bad.append("headline")
    print(f"phase 16: the bench --full in {secs:.1f} s on {rows.get('_meta', {}).get('card')}")
    if bad:
        fail(f"the bench's rows {sorted(set(bad))} are missing, not finite, did not launch "
             "their tracer or disagree with the main paths")
    return rows


def fidelity_phase() -> dict:
    """Phase 17: ``python3 -m bendy_tpu_torch.tools.fidelity`` at its
    defaults on all 12 scenes (the port on the card, the C++ oracle on the
    host's cores) into ``smoke_out/fidelity_torch.json``; each entry held
    to docs/fidelity.json through ``check_against``, with every point of
    the table's entry present. Prints each scene's worst ratio (deviation
    over its band; <= 1 passes) and the phase's seconds; fails on any point
    outside its band. Returns {scene: (worst ratio, the tracer that
    renders it)}."""
    from bendy_tpu_torch import Renderer
    from bendy_tpu_torch.bench import tracer_name
    from bendy_tpu_torch.tools import fidelity

    os.makedirs(SMOKE_DIR, exist_ok=True)
    out = os.path.join(SMOKE_DIR, "fidelity_torch.json")
    t0 = time.perf_counter()
    fidelity.main(["--out", out])
    secs = time.perf_counter() - t0
    with open(out) as f:
        ours = json.load(f)
    with open("docs/fidelity.json") as f:
        ref = json.load(f)
    worst, bad = {}, []
    for name in fidelity.FIDELITY_SCENES:
        if name not in ours:
            print(f"phase 17: {name}: no entry")
            bad.append(name)
            continue
        res = fidelity.check_against(ours[name], ref[name], name)
        missing = sorted(set(ref[name]) - set(ours[name]))
        point, metric, got, want, ratio = max(res["checks"], key=lambda c: c[4])
        scene, cam_ref, _, mb, _ = fidelity.prepare(name, 4)
        r = Renderer(scene, device="cpu")
        worst[name] = (res["worst"], tracer_name(r.trace_config(r.config, cam_ref)))
        band = "flat" if name in fidelity.FLAT_SCENES else "statistical"
        print(f"phase 17: {name} ({band} band): worst ratio {res['worst']:.4f} at {point} "
              f"{metric} ({got!r} against the table's {want!r}); points {len(res['checks'])} "
              f"checks over {sorted(ours[name])}" + (f"; missing {missing}" if missing else ""))
        if not res["ok"] or missing:
            bad.append(name)
    print(f"phase 17: fidelity of 12 scenes in {secs:.1f} s on "
          f"{ours['_meta'].get('card')}; worst ratio {max(w for w, _ in worst.values()):.4f}")
    if bad:
        fail(f"fidelity outside its band on {bad}")
    return worst


SWEEP_SCENES = ("cornell", "cloud")  # phase 18(c): block_sweep's scenes and threads
SWEEP_THREADS = (128, 256)
REPORT_SCENES = ("cornell", "blackhole")  # phase 18(b)


def tiled_passes(dev) -> None:
    """Phase 18(a): every main path of phases 4-12 at its full size, one
    pass with row-major lanes and one tile-major (``make_render_pass(tile=
    ...)``) at the same key, and the (1,1) sharded cornell pass likewise
    (an NCCL world of one in this process): films bit-equal, rays equal.
    Prints the tiling each path's launch gets (``tile_perm`` at its lanes
    per block; the per-item paths at 64 spp decline)."""
    import torch
    import torch.distributed as dist

    from bendy_tpu_torch import Config
    from bendy_tpu_torch.ops.trace_kernel import (lanes_per_block, make_render_pass, tile_perm,
                                                  walks_bvh)
    from bendy_tpu_torch.parallel import initialize, make_kernel_pass_sharded, make_mesh
    from bendy_tpu_torch.parallel.multihost import free_port

    seed = 18
    for (_, name, kw, W, H, spp, n, *_) in MAIN_PATHS:
        r, cam = renderer(name, Config(**kw), W, H, dev)
        r.camera_params(cam)
        cfg = r.trace_config(r.config, cam)
        per_block = lanes_per_block(cfg, walks_bvh(r.arrays, cfg), W * H * n * n, spp)
        outs = [make_render_pass(r.arrays, W, H, H, spp, n, cfg, "full", tile=tile)(
            r._cam_packed, seed, 0, 0) for tile in (False, True)]
        equal = bool(torch.equal(outs[0][0], outs[1][0]))
        rays = (int(outs[0][1]), int(outs[1][1]))
        print(f"phase 18: (a) {name} {W}x{H} {spp} spp {n}x{n}: {per_block} lanes a block, "
              f"tiling {tile_perm(W, H, n * n, per_block)[1]}; tiled film bit-equal to "
              f"row-major {equal}, rays {rays[0]} vs {rays[1]}")
        if not equal or rays[0] != rays[1]:
            fail(f"the tiled {name} pass differs from the row-major one")
    r, cam = renderer("cornell", Config(), 256, 256, dev)
    r.camera_params(cam)
    cfg = r.trace_config(r.config, cam)
    initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl", device="cuda",
               timeout_s=MESH_TIMEOUT_S)
    try:
        mesh = make_mesh(1, 1, "cuda")
        outs = [make_kernel_pass_sharded(r.arrays, mesh, 256, 256, 64, 2, cfg, "full",
                                         tile=tile)(r._cam_packed, seed, 0)
                for tile in (False, True)]
        equal = bool(torch.equal(outs[0][0], outs[1][0])) and int(outs[0][1]) == int(outs[1][1])
    finally:
        dist.destroy_process_group()
    print(f"phase 18: (a) the (1,1) sharded cornell pass, tiled against row-major: bit-equal "
          f"{equal}, rays {int(outs[0][1])} vs {int(outs[1][1])}")
    if not equal:
        fail("the tiled sharded pass differs from the row-major one")


def tools_phase(dev, sweep_builds=()) -> dict:
    """Phase 18: (a) :func:`tiled_passes`; (b) ``tools/perf_report.report``
    on REPORT_SCENES against one measurement of kernel 2's FMA ceiling,
    each row printed and held to :func:`utilization_ok`; (c)
    ``tools/block_sweep`` on SWEEP_SCENES at SWEEP_THREADS threads a block,
    tiled and not, 2 repeats, into smoke_out/block_sweep.json, each
    variant but the default build (phase 3's) first held to the plain
    version by phase 3's cases of those scenes at 16x16 (``sweep_builds``:
    the futures of the variants' builds, started beside phase 2's).
    Returns the report's rows."""
    from bendy_tpu_torch import _build
    from bendy_tpu_torch.tools import block_sweep, perf_report, vpu_peak

    t0 = time.perf_counter()
    tiled_passes(dev)
    t1 = time.perf_counter()
    peak = vpu_peak.measure("fma")
    rows = {}
    for name in REPORT_SCENES:
        row = rows[name] = perf_report.report(name, peak["ops_per_s"])
        print(f"phase 18: (b) perf_report {name}: " + ", ".join(
            f"{k} {v!r}" for k, v in row.items() if k != "count") + f"; counted {row['count']}")
        if not utilization_ok(row):
            fail(f"the perf_report row of {name} has a share outside (0, 1] or a bad rate")
    t2 = time.perf_counter()
    for build in sweep_builds:
        print(f"phase 18: (c) built {build.result()}")  # raises where nvcc failed
    for threads in (t for t in SWEEP_THREADS if t != _build.TRACE_BLOCK):  # phase 3: the default
        with _build.trace_block(threads):
            print(f"phase 18: (c) the {threads}-thread build against the plain version")
            kernel_vs_plain(dev, set(SWEEP_SCENES))
    os.makedirs(SMOKE_DIR, exist_ok=True)
    block_sweep.main([*SWEEP_SCENES, "--threads", *map(str, SWEEP_THREADS), "--repeats", "2",
                      "--out", os.path.join(SMOKE_DIR, "block_sweep.json")])
    print(f"phase 18: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
          f"{time.perf_counter() - t2:.1f} s")
    return rows


# phase 19: the phase probe's scenes and phases (None: every phase with
# something to stub), the stub build's cases against the plain stubbed trace
# at 16x16 (phase 3's cornell, forced onto the BVH too, and cloud: the
# surface, BVH and volume item instantiations); dispatch_probe runs its own
# SCENES at their main paths' shapes
PROBE_PHASES = {"cornell": None, "cloud": ("volume", "marchspec", "floor"),
                "prim_grid_256": ("sweep", "floor")}
STUB_CASES = (("cornell", 4, 7, {}), ("cornell", 4, 7, BVH), ("cloud", 2, 11, {}))


def stub_build_vs_plain(dev, stub_build) -> float:
    """Phase 19(a): the stub build (``stub_build``: the future of its
    build, started beside phase 2's) prints its ptxas lines and its
    unstubbed instantiations' registers beside the default build's; then
    every instantiation it has, at every phase of the probe, held to the
    plain trace with the same phase stubbed (``tools/phase_probe.stubbed``)
    on STUB_CASES, as phase 3 holds production. Returns the largest |diff|."""
    import torch

    from bendy_tpu_torch import Config, _build
    from bendy_tpu_torch.ops.trace_kernel import make_tracer
    from bendy_tpu_torch.ops.wavefront import trace_core
    from bendy_tpu_torch.tools import phase_probe
    from bendy_tpu_torch.utils.rng import render_key

    lib, build_s = stub_build.result()  # raises where nvcc failed
    lines = ptxas_report(_build.build_log(stubs=True))
    print(f"phase 19: (a) built the stub build ({lib.parent.name}) in {build_s:.1f} s; ptxas: "
          + " | ".join(lines))
    default = {ln.split(":")[0]: ln.split(": ", 1)[1] for ln in ptxas_report(_build.build_log())}
    for ln in lines:
        label, regs = ln.split(": ", 1)
        if ",STUB=0>" in label:
            prod = label.replace(",STUB=0>", ">")
            print(f"phase 19: (a) {label}: {regs}; the default build's {prod}: "
                  f"{default.get(prod)}")
    W = H = 16
    pix = torch.arange(W * H, dtype=torch.int32, device=dev)
    sub = torch.zeros(W * H, dtype=torch.int32, device=dev)
    worst = 0.0
    for name, spp, seed, variant in STUB_CASES:
        r, cam = renderer(name, Config(max_bounces=3), W, H, dev)
        cfg = variant_config(r.trace_config(r.config, cam), variant)
        params = r.camera_params(cam)
        for phase in (None, *phase_probe.PHASES):
            with phase_probe.stubbed(phase):
                kern = make_tracer(r.arrays, W, H, spp, 1, cfg)(r._cam_packed, seed, 0, pix, sub)
                plain = trace_core(r.arrays, params, render_key(seed, 0), pix, sub, W, H, spp, 1,
                                   cfg)
                torch.cuda.synchronize()
            tag = (f"(a) {name} spp {spp}{' bvh' if variant else ''} {phase or 'full'} (stub mask "
                   f"{phase_probe.stub_mask(phase)})")
            worst = max(worst, compare_lanes(tag, kern, plain, cfg, phase=19))
    return worst


def probes_phase(dev, stub_build) -> dict:
    """Phase 19: (a) :func:`stub_build_vs_plain`; (b) ``tools/phase_probe``
    on PROBE_PHASES (each variant's time per warp-iteration and op count,
    every number finite and positive) and the march share of cloud, into
    smoke_out/phase_probe_torch.json; (c) ``tools/prim_scaling`` over both
    routes at its counts into smoke_out/prim_scaling_torch.json (every row's
    Mrays/s finite and positive, the BVH walked exactly on the bvh route);
    (d) ``tools/dispatch_probe`` on its SCENES into
    smoke_out/dispatch_probe_torch.json (every scene's passes captured, the
    graph's film bit-equal to the chain's with equal rays). Returns {"phase_split": {scene: split},
    "march_share": ..., "prim_scaling": {...}, "dispatch": {scene: row}}."""
    import math

    from bendy_tpu_torch.tools import dispatch_probe, phase_probe, prim_scaling, write_json

    t0 = time.perf_counter()
    err = stub_build_vs_plain(dev, stub_build)
    t1 = time.perf_counter()
    split = {}
    for name, phases in PROBE_PHASES.items():
        split[name] = phase_probe.probe(name, phases)
        for tag, row in split[name].items():
            print(f"phase 19: (b) {name} {tag}: " + ", ".join(f"{k} {v!r}" for k, v in row.items()))
            nums = [v for k, v in row.items() if k != "stub_mask" and not k.startswith("phase_")]
            if not all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0 for v in nums):
                fail(f"phase_probe {name} {tag}: a time, count or rate is not finite and positive")
    share = phase_probe.march_record("cloud")
    print(f"phase 19: (b) cloud march share (volume events over rays): {share!r}")
    if not 0.0 < share["march_share"] < 1.0:
        fail(f"cloud's march share {share['march_share']!r} is not in (0, 1)")
    os.makedirs(SMOKE_DIR, exist_ok=True)
    write_json(os.path.join(SMOKE_DIR, "phase_probe_torch.json"),
               {"scenes": split, "march_share": {"cloud": share}}, dev,
               seconds=time.perf_counter() - t1)
    t2 = time.perf_counter()
    out = os.path.join(SMOKE_DIR, "prim_scaling_torch.json")
    prim_scaling.main(["--out", out])
    with open(out) as f:
        scaling = json.load(f)
    for row in scaling["rows"]:
        print(f"phase 19: (c) prim_grid({row['n_field_prims']}) {row['route']}: "
              f"{row['mrays_median']!r} Mrays/s median ({row['mrays_best']!r} best), tracer alone "
              f"{row['kernel_ms']!r} ms, first call {row['first_call_s']!r} s, bvh {row['bvh']}")
        if not (math.isfinite(row["mrays_median"]) and row["mrays_median"] > 0
                and row["bvh"] == (row["route"] == "bvh")):
            fail(f"prim_scaling row {row['route']} {row['n_field_prims']} is wrong")
    print(f"phase 19: (c) crossover by Mrays/s median at {scaling['crossover_mrays_median']}, by "
          f"the tracer alone at {scaling['crossover_kernel_ms']} primitives (the threshold is "
          f"192)")
    t3 = time.perf_counter()
    dispatch = {}
    for name in dispatch_probe.SCENES:
        row = dispatch[name] = dispatch_probe.measure(name)
        if not row["captured"]:
            fail(f"{name}'s passes were not captured ({row['capture_error']}) at "
                 f"{row['stopped_at']}")
        print(f"phase 19: (d) {name}: chain {row['chain_s_median']!r} s, graph "
              f"{row['graph_s_median']!r} s for {row['passes']} passes: "
              f"{row['dispatch_ms_per_pass']!r} ms a pass; films bit-equal "
              f"{row['films_bit_equal']}, rays equal {row['rays_equal']}")
        if not (row["films_bit_equal"] and row["rays_equal"]):
            fail(f"the graph of {name}'s passes differs from the chain")
    write_json(os.path.join(SMOKE_DIR, "dispatch_probe_torch.json"),
               {"rows": list(dispatch.values())}, dev, seconds=time.perf_counter() - t3)
    print(f"phase 19: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) {t3 - t2:.1f} s, (d) "
          f"{time.perf_counter() - t3:.1f} s; stub build max |diff| {err:.3e}")
    return {"phase_split": split, "march_share": share, "dispatch": dispatch,
            "prim_scaling": {k: scaling[k] for k in ("crossover_mrays_median",
                                                     "crossover_kernel_ms")}}


# the benchmark's cells (BENCHMARK.json): scene, Config, width, height, spp, subsample
WARP_USE_CELLS = (("cornell", {}, 256, 256, 64, 2), ("cornell", {}, 768, 512, 1, 2),
                  ("blackhole", {"max_bounces": 2}, 1920, 1080, 256, 1),
                  ("mass_cluster", {}, 1920, 1080, 16, 1))


def warp_use_vs_issued(dev) -> list:
    """Phase 20: one pass of each of :data:`WARP_USE_CELLS` under
    ``torch.profiler`` counts the tracer's warp use, each launch its own
    (``telemetry.counters()``); the same key's per-thread counts
    (``make_tracer(..., count_items=True)`` on the Renderer's lanes, in
    launch order by ``perf_report.thread_counts``) give ``warp_use``'s pair,
    which must equal the counters integer for integer. Every cell's lanes,
    so every launch's threads, are a multiple of 32, so no warp spans two
    launches. On the LOOPM path (mass_cluster) the threads take items from
    the pool: the thread iterations must equal the items' iteration sum, and
    the tracer must issue a multiple of 32 no fewer; ``warp_use`` (one item a
    thread) and the pool model (``warp_use_pool_plain`` at the launch's
    threads) are printed beside it. Returns the rows."""
    import torch

    from bendy_tpu_torch import _build, telemetry
    from bendy_tpu_torch.bench import renderer_lanes
    from bendy_tpu_torch.film import DeviceFilm
    from bendy_tpu_torch.ops.trace_kernel import (item_occupancy, make_tracer, pools_items,
                                                  tracer_table, warp_use, warp_use_pool_plain)
    from bendy_tpu_torch.render import Config, RenderConfig, Subsample
    from bendy_tpu_torch.tools.perf_report import thread_counts

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    rows = []
    for name, kw, W, H, spp, n in WARP_USE_CELLS:
        r, cam = renderer(name, Config(**kw), W, H, dev)
        film, seed = DeviceFilm(W, H, device=dev), 2**31 + 20
        telemetry.clear()
        with torch.profiler.profile(activities=acts):
            r.render(cam, RenderConfig(samples=spp, subsample=Subsample(n)), film, seed=seed)
        got = telemetry.counters()
        cfg = r.trace_config(r.config, cam)
        pix, sub = renderer_lanes(r, cfg, W, H, spp, n)
        res = make_tracer(r.arrays, W, H, spp, n, cfg)(r._cam_packed, seed, 0, pix, sub,
                                                         count_items=True)
        _, iters = thread_counts(res, pix.numel(), spp, cfg)
        want = dict(zip(("loop_thread_iters", "loop_issued_iters"), warp_use(iters).tolist()))
        row = dict(cell=f"{name} {W}x{H} {spp}spp {n}x{n}", counters=got, recomputed=want,
                   warp_use=100.0 * got["loop_thread_iters"] / max(got["loop_issued_iters"], 1))
        if pools_items(cfg):
            table_np, counts = tracer_table(r.arrays.host_copy(), cfg)
            _, per_sm, sms = item_occupancy(cfg, table_np.size, counts)
            threads = min(per_sm * sms * _build.TRACE_BLOCK, iters.numel())
            model = torch.zeros(2, dtype=torch.int64)
            warp_use_pool_plain(iters.cpu(), model, threads)
            row.update(threads=threads, pool_model=model.tolist())
            print(f"phase 20: {row['cell']}: the pool's counters {got} (loop_warp_use "
                  f"{row['warp_use']:.4f} %); from the per-thread counts, one item a thread "
                  f"{want} ({100 * want['loop_thread_iters'] / want['loop_issued_iters']:.4f} "
                  f"%), the pool model at {threads} threads {model.tolist()} "
                  f"({100 * model[0] / model[1]:.4f} %)")
            issued_ok = (got["loop_issued_iters"] % 32 == 0
                         and got["loop_issued_iters"] >= got["loop_thread_iters"])
            ok = got["loop_thread_iters"] == want["loop_thread_iters"] and issued_ok
        else:
            print(f"phase 20: {row['cell']}: counters {got}, from the per-thread counts {want}: "
                  f"loop_warp_use {row['warp_use']:.4f} %")
            ok = got == want
        if pix.numel() % 32 or not ok or not 0 < got["loop_thread_iters"]:
            fail(f"the warp-use counter of {row['cell']} disagrees with warp_use")
        rows.append(row)
        del res, iters
        torch.cuda.empty_cache()
    telemetry.clear()
    return rows


def parent_code(lib_path, parent_build) -> None:
    """Phase 2 with a parent checkout: every tracer instantiation's opcodes
    (``sweep_sass.same_tracers``) and every ptxas line against the parent's
    library. Only the LOOPM instantiations may differ; their lines are
    printed beside the parent's."""
    from bendy_tpu_torch import _build
    from bendy_tpu_torch.tools import sweep_sass

    plib, plog = parent_build.result()
    same = sweep_sass.same_tracers(sweep_sass.library_listing(lib_path),
                                   sweep_sass.library_listing(plib))
    mine, theirs = ({ln.split(": ")[0]: ln for ln in ptxas_report(log)}
                    for log in (_build.build_log(), plog))
    others = [k for k in same if "LOOPM=1" not in k]
    code_off = [k for k in others if not same[k]]
    lines_off = [k for k in mine if "LOOPM=1" not in k and mine[k] != theirs.get(k)]
    print(f"phase 2: opcodes equal to the parent's library: {len(others) - len(code_off)} of "
          f"{len(others)} instantiations without LOOPM, LOOPM " + ", ".join(
              f"{k} {same[k]}" for k in same if "LOOPM=1" in k)
          + f"; ptxas lines equal but LOOPM's: {not lines_off}; LOOPM, change | parent: "
          + " | ".join(f"{mine[k]} | {theirs.get(k)}" for k in mine if "LOOPM=1" in k))
    if code_off or lines_off:
        fail(f"instantiations without LOOPM differ from the parent's: {code_off + lines_off}")


def run(phases=None, phase3_names=None, parent=None) -> int:
    """Run the phases in ``phases`` (all when None; the card and the build
    always run), phase 3 on the cases of ``phase3_names`` only when given;
    with ``parent``, the root of the parent's checkout, phase 2 also holds
    the build to the parent's library (:func:`parent_code`)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using {torch.cuda.get_device_name(0)}; {smi}")

    from concurrent.futures import ThreadPoolExecutor

    from bendy_tpu_torch import Config, _build
    from bendy_tpu_torch.ops import trace_kernel
    from bendy_tpu_torch.tools import sweep_sass

    # builds beside the default one: the sweep's lineinfo build, phase 18's and 19's
    sweep_builds, stub_build = [], None
    pool = ThreadPoolExecutor()
    listing = pool.submit(sweep_sass.lineinfo_listing)
    if phases is None or 18 in phases:
        sweep_builds = [pool.submit(_build.build, t) for t in SWEEP_THREADS
                        if t != _build.TRACE_BLOCK]
    if phases is None or 19 in phases:
        stub_build = pool.submit(_build.build, None, True)
    parent_build = None if parent is None else pool.submit(sweep_sass.checkout_library, parent)
    pool.shutdown(wait=False)
    lib_path, build_s = _build.build()
    print(f"phase 2: built {lib_path.name} in {build_s:.1f} s; ptxas: "
          + " | ".join(ptxas_report(_build.build_log())))
    print(f"phase 2: ptxas on wgmma: {wgmma_warnings(_build.build_log()) or 'no warning'}")
    print(f"phase 2: the item instantiations' register budgets: {item_budgets()}")
    sweep = sweep_sass.sass_counts(lib=lib_path, listing=listing.result())
    print(f"phase 2: SASS of the surface sweep per loop iteration "
          f"({sweep['instantiation']}; tools/sweep_sass.py): {json.dumps(sweep['loops'])}")
    print(f"phase 2: SASS of the geodesic chords' sweep per loop iteration "
          f"({sweep['geodesic']['instantiation']}): {json.dumps(sweep['geodesic']['loops'])}")
    if not sweep["lineinfo_matches_library"]:
        fail("the sweep's lineinfo build does not hold the library's instructions")
    if parent_build is not None:
        parent_code(lib_path, parent_build)

    err16 = {}
    if phases is None or 3 in phases:
        err16 = kernel_vs_plain(dev, phase3_names)

    kernels = []
    paths = {}  # main path name: (Mrays/s, occupancy at the bench's seed), for phase 16
    for (phase, name, kw, W, H, spp, n, wrapper, pass_spp, rows, replaces) in MAIN_PATHS:
        if phases is not None and phase not in phases:
            continue
        launch = getattr(trace_kernel, wrapper)
        path = main_path(phase, name, Config(**kw), W, H, spp, n, dev, launch)
        k = kernel_alone_and_passes(phase, path, W, H, spp, n, pass_spp, rows, launch, dev)
        paths[name] = (path["rays"] / path["dt"] / 1e6, k["occupancy"])
        label = f"{name} {W}x{H} {spp}spp" + (f" {n}x{n}" if n > 1 else "")
        kernels.append({
            "name": wrapper,
            "route": "cuda",
            "source": "bendy_tpu_torch/csrc/trace_surface.cu",
            "replaces": replaces,
            "launches": path["launches"],
            "max_abs_err": k["max_err"],
            "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": None,
            "path": label,
            "ms_min": k["kernel_ms_min"],  # ms is the median of REPEATS seeds, per launch
            "ms_max": k["kernel_ms_max"],
            "launches_per_pass": k["chunks"],  # per item: one per chunk, each with its fold
            "pass_ms": k["pass_ms"],
            "pass_spp": k["pass_spp"],  # pass_ms, plain_ms and max_abs_err
            "plain_rows": rows,
            "max_abs_err_16x16": err16.get(wrapper),
            "rays_per_launch": k["rays"],
            "volume_events_per_launch": k["vol_events"],
            "rk4_steps_per_launch": k["rk4_steps"],
            "mrays_per_s": path["rays"] / path["dt"] / 1e6,
            "s_per_pass": path["dt"] / 4,
        })
        if k["tests"] is not None:  # the BVH walk (the looped-sweep paths)
            kernels[-1].update(sweep_floor_ms=k["sweep_floor_ms"],
                               node_tests_per_segment=k["tests"][0],
                               prim_tests_per_segment=k["tests"][1],
                               bvh_table_build_ms=k["table_ms"])
        if name == "cornell":
            kernels[-1]["sweep_sass_per_iteration"] = sweep["loops"]
        if name == "blackhole":
            kernels[-1]["sweep_sass_per_iteration"] = sweep["geodesic"]["loops"]
        kernels[-1].update(host_ms_per_pass=path["host_s"] / 4 * 1e3,
                           pass_wall_minus_kernel_ms=k["glue_ms"],
                           rays_per_warp_issue_slot=k["occupancy"])
        a = k["accumulate"]
        kernels.append({
            "name": "accumulate", "route": "cuda", "source": "bendy_tpu_torch/csrc/accumulate.cu",
            "replaces": f"{replaces}: the pass's subpixel sum, film add and ray count "
                        "(bendy_tpu/render.py:224-226)",
            "launches": path["accumulates"], "max_abs_err": a["max_err"], "ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"], "bound_by": "bytes",
            "library_ms": a["library_ms"],
            "library_form": "the parent's route: pixel_sums, += and the int64 ray sum",
            "path": label, "ms_min": a["ms_min"], "ms_max": a["ms_max"],
            "timed_by": "20 launches in a CUDA graph, median of 7 replays",
            "call_ms": a["call_ms"], "library_call_ms": a["route_call_ms"],
        })
        if k["fold"] is not None:
            f = k["fold"]
            kernels.append({
                "name": "fold_samples", "route": "cuda",
                "source": "bendy_tpu_torch/csrc/trace_surface.cu",
                "replaces": f"{replaces}: the ordered fold of its split over samples",
                "launches": path["folds"], "max_abs_err": f["max_err"], "ms": f["ms"],
                "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"], "bound_by": "bytes",
                "library_ms": f["library_ms"], "library_form": "torch.sum over the samples",
                "path": label, "ms_min": f["ms_min"], "ms_max": f["ms_max"],
            })

    if phases is None or 13 in phases:
        s = sharded_pass(dev)
        kernels.append({
            "name": "make_kernel_pass_sharded", "route": "cuda",
            "source": "bendy_tpu_torch/csrc/trace_surface.cu",
            "wrapper": "bendy_tpu_torch/parallel/mesh.py::make_kernel_pass_sharded",
            "replaces": "bendy_tpu/parallel/mesh.py:146",
            "launches": s["launches"], "max_abs_err": s["max_err"], "ms": s["kernel_ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": None, "path": "cornell 256x256 64spp 2x2, (1,1) mesh, nccl",
            "pass_spp": s["pass_spp"], "mrays_per_s": s["rays"] / s["dt"] / 1e6,
            "s_per_pass": s["dt"] / 4, "bench_path": "sharded",
        })
    if phases is None or 14 in phases:
        cli_on_card(dev)
    if phases is None or 15 in phases:
        kernels += probes(dev)
    if phases is None or 16 in phases:
        rows = bench_phase(paths)
        cornell = next((e for e in kernels if e.get("path", "").startswith("cornell ")), None)
        if cornell is not None:
            cornell["fp32_utilization"] = rows[UTILIZATION_ROW]
        for row_name, row in rows.items():
            path = BENCH_PATH.get(row_name)
            for entry in kernels:  # the row joins its main path's tracer entry
                if entry.get("bench_path", entry.get("path", "").split(" ")[0]) == path and \
                        entry["name"] in (row["tracer"], "make_kernel_pass_sharded"):
                    entry.setdefault("bench", {})[row_name] = row
                    break
    if phases is None or 17 in phases:
        worst = fidelity_phase()
        for tracer in ("trace_surface", "trace_geodesic", "trace_volume"):
            entry = next((e for e in kernels if e["name"] == tracer), None)
            if entry is not None:  # each scene's worst ratio on the first entry of its tracer
                entry["fidelity_worst_ratio"] = {
                    name: ratio for name, (ratio, t) in worst.items() if t == tracer}

    if phases is None or 18 in phases:
        util = tools_phase(dev, sweep_builds)
        entry = next((e for e in kernels if e.get("path", "").startswith("cornell ")), None)
        if entry is not None:
            entry.setdefault("fp32_utilization", util["cornell"])

    if phases is None or 19 in phases:
        res = probes_phase(dev, stub_build)
        for entry in kernels:  # each scene's results join its main path's tracer entry
            if entry["name"] not in ("trace_surface", "trace_volume"):
                continue
            scene = entry.get("path", "").split(" ")[0]
            if scene in res["phase_split"]:
                entry["phase_split"] = res["phase_split"][scene]
            if scene in res["dispatch"]:
                entry["dispatch"] = res["dispatch"][scene]
            if scene == "cloud":
                entry["march_share_events"] = res["march_share"]["march_share"]
            if scene == "prim_grid_256":
                entry["prim_scaling"] = res["prim_scaling"]

    if phases is None or 20 in phases:
        warp_use_vs_issued(dev)

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    return run()


if __name__ == "__main__":
    sys.exit(main())
