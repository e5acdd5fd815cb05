// trace_surface.cu: the path tracer as one CUDA kernel for Hopper (sm_90a).
//
// Replaces bendy_tpu/ops/pallas_trace.py::make_pallas_tracer (the
// pl.pallas_call at pallas_trace.py:255, running
// bendy_tpu/ops/wavefront.py::trace_core) in all its configurations,
// compile-time instantiations of one kernel template behind three C entry
// points:
//   - bendy_trace_surface  (GEO = false, VOL = false): the surface
//     configuration (1a);
//   - bendy_trace_geodesic (GEO = true, VOL = false): the geodesic
//     configuration with unrolled masses (1d): RK4 chord stepping around up
//     to 8 point masses (bendy_tpu/geodesic.py:124,145,177,373;
//     wavefront.py:550-599, 649-652, 682-689);
//   - bendy_trace_volume (VOL = true, GEO from FLAG_GEO): participating
//     media, both the baked sparse grid (1b: ops/volume.py::density_sample,
//     scalar unroll :182-216) and the dense-grid brick fetch (1c:
//     ops/volume.py::_density_operand :248, pack_vol_operand :99), with
//     volume_shade (:489-520) and the march mode of trace_core
//     (wavefront.py:544-548, 593-604, 697-746); with GEO, geodesics inside
//     media (wavefront.py:559-572, 589, 738-739);
//   - the looped table sweeps (1e), in every entry point: the light sweep
//     (1e-ii: ops/materials.py::sample_light_point_looped :132,
//     intersect.py::light_pdf_looped :1183) is the same run-time loop over
//     the shared-memory table that every instantiation runs
//     (sample_light_point, light_pdf below): the TPU needs a looped form
//     because an XLA unroll's compile time grows with the count and Mosaic
//     indexes only SMEM by a traced row, and the reference proves its two
//     forms equal. The primitive sweep (1e-i: bendy_tpu/ops/intersect.py::
//     nearest_hit_looped :740 over prim_tables :495) is the run-time loop of
//     nearest_hit below in small scenes; past render.LOOP_SWEEP_THRESHOLD
//     primitives without geodesics the BVH instantiations (FLAG_BVH, in
//     bendy_trace_surface and bendy_trace_volume) walk a tree of boxes over
//     the primitives instead (nearest_hit_bvh, ops/bvh.py), with the
//     sweep's winner bit for bit. The looped mass sweep
//     (1e-iii: bendy_tpu/geodesic.py::geo_step_begin_looped :236,
//     _acc_looped :309, rk4_step_looped :349 over mass_table :196) computes
//     another discretization, so it is an instantiation of its own: LOOPM
//     (FLAG_LOOPM, with GEO, in bendy_trace_geodesic and bendy_trace_volume),
//     one thread per (lane, sample), whose samples a second kernel behind
//     bendy_fold_samples adds in order (fold_kernel). The unrolled-mass and
//     volume instantiations without the BVH split the same way (the item
//     instantiations, below).
// Its plain PyTorch version is bendy_tpu_torch/ops/wavefront.py::trace_core
// (geodesic mode: bendy_tpu_torch/geodesic.py; media:
// bendy_tpu_torch/ops/volume.py); the wrappers and the table layout are in
// bendy_tpu_torch/ops/trace_kernel.py.
//
// What it computes: for every lane (one pixel x subpixel) the whole
// regenerating wavefront loop over spp samples: finalize a dead path and
// regenerate its camera ray, apply the bounce cap, find the nearest hit over
// spheres, rects and three-slab boxes, draw the pcg4d uniforms, shade the
// surface (diffuse next-event mixture, metallic fuzz, glass) or add the
// environment on a miss, update radiance and throughput, claim the AOVs.
//
// What bounds it on the H100: FP32 issue and warp divergence across paths of
// unequal length, not bytes (the scene is a few KB, each lane reads 8 bytes
// and writes 12 or 40); on the surface paths also the sweep's shared loads
// and IEEE divisions (below). In the geodesic instantiation the FP32 issue of the
// four RK4 stages (each a sweep over the masses with a divide and a sqrt)
// dominates every chord step, and divergence grows: photon-ring lanes that
// graze the critical impact parameter run to hundreds of chord steps
// against a mean near 22 segments per sample, and hold their warp. Design:
//   - one thread per lane in the surface and BVH instantiations; the thread
//     runs its own loop over all its samples and exits on its own (Hopper's
//     per-thread control flow in place of the TPU's per-block masked loop). A
//     warp runs until its slowest lane is done. On the surface paths the
//     lane loop beat splitting a lane's samples over threads, K samples a
//     thread into per-item words and the fold, at every K from 1 to 16:
//     what a split saves of the tail of a launch 2.6-3.1 waves deep (cornell
//     at 256x256x4 lanes) it loses in warp slots, 0.41-0.79 rays per slot
//     against 0.88, and in the words it writes (PERF.md §6). The geodesic
//     instantiations and the volume ones without the BVH instead run one
//     thread per (lane, sample) (PER_ITEM: the LOOPM and the item
//     instantiations, below) and fold the samples afterwards.
//   - lane state stays in registers; each lane shades only its own material
//     instead of evaluating every branch under a mask.
//   - the scene is NOT baked: the compiled tables arrive as one flat f32
//     buffer with run-time counts and are staged into shared memory per
//     block, so editing or moving an object rebuilds nothing. A table past
//     the 227 KiB a block can stage (FLAG_GTAB, chosen by the wrapper) is
//     read in place from global memory instead, through L1 like the density
//     grids: the GTAB instantiations, a template flag of their own, so that
//     the shared-memory ones compile as before.
//   - the TPU workarounds are gone: bool state, native uint32_t RNG words,
//     no lane-varying zero seeds.
//   - geodesics and media are template parameters, so the surface
//     instantiation compiles as it did before they existed; every volume
//     addition is an `if constexpr (VOL)` block, so the surface and geodesic
//     instantiations compile to the same code as without media (ptxas
//     reports the same registers). The geodesic one reads the
//     mass block [M,4] from the same shared-memory table, keeps the frozen
//     per-mass h² in a float[8] that only fully unrolled loops with constant
//     indices touch (so it stays in registers), takes the RK4 step only on
//     lanes that are near a mass (a far-field lane traces straight and never
//     reads the chord), and reads the GeoParams as launch arguments, so
//     editing a scene's "geodesic" block rebuilds nothing.
//
// The row sweep (the SWEEP_ROWS instantiations, nearest_hit_rows: kernel
// 1a's segments and kernel 1d's geodesic chords):
//   - What bounds it: cornell's primitive sweep was 0.68 of a warp-iteration
//     (PERF.md §5, tools/phase_probe.py). In SASS (tools/sweep_sass.py) an
//     iteration of the flat sweep took a rect 87 instructions, 14 of them
//     32-bit shared loads (a row is 21 floats, so no load was wider), and an
//     IEEE division; a box 208, with 21 loads, 41 selects (the oriented
//     normals and signs it carried) and three IEEE reciprocals. cornell
//     sweeps 6 rects and 2 boxes a segment.
//   - Design: (a) float4 rows of the fields a test reads, staged by the
//     block in front of the table (4 LDS.128 a rect or box, 1 a sphere); a
//     box carries the index and sign of its winning slab, and its sgn_lo /
//     sgn_hi, its normal and every shading field come from the winner's flat
//     row after the sweep. (b) A rect divides and tests containment only
//     where quotient_may_win says its t may still win (ptxas shares the
//     division's MUFU.RCP with it). (c) The FULL-output instantiation holds 8
//     blocks of 128 an SM (64 registers, 16 B spilled). An iteration now
//     takes a rect 81.5 instructions and a box 163 (15 FSEL).
//   - Measured on an NVIDIA H100 80GB HBM3 at 700.00 W in one run of
//     tools/checkout_ab.py (the previous design, this, this, the previous
//     design; medians of 7 seeds): cornell's tracer 4.192 / 4.191 -> 3.643
//     / 3.628 ms, cornell2 4.496 / 4.514 -> 3.872 / 3.921, scene.json 1.918
//     / 1.883 -> 1.847 / 1.813, films and rays bit-equal. cornell's bound
//     (chip_smoke.trace_bound, a rect counted at its reject alone) is
//     0.194 ms. Each lever against the one before (PERF.md §6):
//     the rows 4.23-4.26 -> 4.08 ms; the rect reject 3.72-3.74, although a
//     whole warp could skip only 2.7 % of its rect tests (a lane 62 %); the
//     box reject lost (3.77-3.80: its approximate slabs cost 76 instructions
//     a box, more than the 57 % of box tests that whole warps skipped
//     saved); 256 threads lost; 8 blocks won 2 % on cornell and cornell2.
//   - Geodesic chords (kernel 1d) sweep the same rows. A chord's clip is
//     short, so on blackhole (512x512, 32 spp, 2 bounces) a lane could skip
//     94.5 % of its rect tests and a whole warp 94.1 % (cornell: 62 %,
//     2.7 %); a sphere's iteration 54 -> 49.5 instructions, a rect's 84.5
//     with 14 LDS -> 77.5 with 4 LDS.128. On an NVIDIA H100 80GB HBM3 at
//     700.00 W the tracer of a 1920x1080, 256-spp blackhole pass took
//     620.8 -> 527.2 ms (the benchmark's blackhole.batch, traced).
//
// The lane pool (LANE_POOL: the surface instantiation in FULL output with
// its table staged, in the template's LOOPM slot; chosen by launch<> from
// the launch's shape, pools_lanes):
//   - What it cures: at one sample a lane (the interactive loop, 768x512,
//     2x2, a pass a frame) a thread traces one path, and a warp issues
//     until its longest path ends: 44.6 % of the iterations its warps
//     issued did work (loop_warp_use), against 88 % at 64 samples a lane.
//   - Design: a resident grid (the blocks its SMs hold at once); a thread
//     starts on lane = its index and, when its lane's samples are done or
//     the lane is cut at the cap, writes the lane's words at the lane's
//     index, takes the next lane and starts it afresh in the same loop
//     iteration. A lane is still traced whole by one thread in sample
//     order, so out, rays and iters are bit-equal to one thread a lane.
//   - Draws: a warp claims LANE_RUN lanes with one atomicAdd on the
//     launch's own counter (zeroed on its stream by launch<>) and hands them
//     to its threads in rank order (lane_take, the run kept in shared
//     memory by the warp's thread 0): at one sample about a third of a
//     warp's threads end a path each iteration, and a draw each would near
//     the L2's rate of atomics on one address. So every thread of a warp
//     stays in the loop until all 32 are done (a thread without a lane
//     waits at the loop's head) and the warp votes with all 32 each
//     iteration.
//   - Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6): at
//     768x512, 2x2, 1 spp the tracer 0.396 -> 0.293 ms, its warps 44.6 ->
//     86.5 % used; a warp-iteration costs about 43 % more, since the lane's
//     stores, the next lane's camera ray and the vote now run, diverged,
//     in most iterations. Hence pools_lanes: where a thread gets fewer than
//     3 lanes the tail when the pool empties costs what the pool saves, and
//     past 16 samples a lane the warps already run nearly full.
//
// Numerics (held per lane to the plain version at rtol 5e-4, atol 1e-5):
//   - Trig: the same range-free polynomials as ops/distr.py::sin_cos_tau and
//     sin_cos_small, not sinf/cosf (frustum trig falls back to sinf/cosf only
//     when the renderer does not set frustum_poly, as the reference does).
//   - Never built with --use_fast_math: it flushes denormals and
//     approximates division and sqrt, and lanes near a branch edge would
//     drift. Normalization is 1.0f / sqrtf(x), both correctly rounded (the
//     plain version computes the same; torch.rsqrt on the card is rsqrtf).
//   - Built with --fmad=false: every expression is written in the plain
//     version's operation order, so without contraction the kernel rounds
//     as the plain version's separate PyTorch ops do. Contraction is allowed
//     by the tolerance, but the large ground sphere of scene.json is
//     ill-conditioned (|oc|^2 - r^2 cancels at r = 1000): there one rounding
//     more or less (a contracted multiply-add) moves t enough to shift summed
//     AOV normals by ~1e-4, past atol 1e-5. Turning FMA back on is a speed
//     question for later.
//   - Float constants are written (float)(double expression), which is how
//     the reference rounds its Python-double constants to f32.
//   - Infinities: the per-sample depth starts at +INF and an emissive
//     environment reports INF depth; depth_n clamps it to 1 as jnp.clip does.
//   - Float -> int: the light pick (int)(u0 * nl) truncates toward zero, as
//     jax's astype does (materials.py:231-233).
//   - RNG words are bit-equal to utils/rng.py: pcg4d, top-24-bit unit
//     floats, tags path_step*16+block and CAMERA_TAG*16, stream id
//     (pix*spp_total + sample0 + s)*nn + sub in wrapping u32.
//   - Host calls: the C entry takes every pointer and the stream as void*
//     (the wrapper declares ctypes argtypes), and returns cudaGetLastError()
//     after the launch, because a refused launch (too many registers or too
//     much shared memory) never runs and synchronize() does not report it.
//
// Geodesic numerics, where trouble is likely (geodesic.py is the order):
//   - Chaos near the photon sphere: lanes that graze b_crit = (3√3/2)·rs flip
//     between capture and escape on one rounding. The kernel keeps the
//     reference's order exactly: h² by the Lagrange identity
//     max(r²·|d|² − (rel·d)², 0); inv_r = r² > 0 ? 1/sqrtf(max(r², 1e-20)) : 0
//     and inv_r⁵ as four multiplies left to right; the RK4 sums as
//     (k1 + (k2 + k3)·2 + k4)·(ds·(1/6)); the step eta·(1 + growth·steps).
//     Without contraction it then rounds as the plain version does.
//   - The step budget (geo_steps > max_steps) binds only surface lanes, not
//     marching ones; geo_steps advances only on near segments; capture
//     applies to every alive lane.
//   - The chord: seg_dir = chord·(1/max(|chord|, 1e-20)) and the clip
//     [fresh ? clip_min : 0, near ? |chord| : clip_max]. A far-field lane
//     traces straight along dir with the full clip. A miss inside a near
//     chord continues bending from (x_next, d_next) and shades no
//     environment.
//   - Dead lanes compute nothing, so no NaN from a lane parked at a mass
//     center reaches the state a regeneration reads.
//   - n_mass == 0 would leave r2_min at +INF: the geodesic entry refuses any
//     n_mass outside [1, 8] (at least 1 with FLAG_LOOPM), as the wrapper does.
//
// Looped masses (the LOOPM instantiations; geodesic.py's *_looped functions
// are the order):
//   - geo_step_begin_looped is one pass over the n_mass rows of the mass
//     block: capture, far field and r2_min in row order, and no h² array, so
//     nothing of size M lives in registers. The reference pads its table to
//     MASS_BLOCK rows with rs = 0 and masks them; over the real rows alone
//     the function is the same, so the table carries no padding.
//   - acc_looped recomputes h² at every RK4 stage from that stage's x and d
//     (h2 = max(r2·d2 − rd·rd, 0)) and applies s = (−1.5·rs)·(h2·inv_r⁵), an
//     association other than acc_frozen's, summed in row order. Without
//     contraction it is bit-equal to the plain version. Among 64 masses an
//     RK4 stage point now and then lands near a mass and the next one is
//     thrown past f32's range (r² = inf): the max keeps the NaN of inf − inf
//     there, as the plain version's clamp does, so both lanes go NaN alike
//     (with fmaxf the kernel went on and added the environment).
//   - What bounds it: FP32 issue, 4 stages × M masses × ~25 operations per
//     chord step (at M = 64 some 6,400, with a divide and a sqrt per mass
//     and stage), and the straggler tail: one thread per lane ran a
//     photon-ring lane's 16 samples one after another (16 × 258 iterations
//     against a mean of 379) on an SM that had emptied, with 65,536 lanes
//     filling a quarter of the card's thread slots.
//   - So one thread traces one (lane, sample): thread `item` takes sample
//     item % spp of lane item / spp (spp: the samples of this launch, a
//     chunk of the call's when the wrapper splits them), so the samples of
//     one lane sit side by side and a photon-ring pixel's long samples share
//     a warp. The thread runs the lane loop below with a sample range of
//     one and the same stream ids, so every RNG word is the same, and writes
//     that sample's sums (depth_n applied) and counts (rays, iterations,
//     volume events, RK4 steps) to per-item buffers [words, n·spp].
//     fold_kernel then adds each lane's items in sample order from 0, as
//     the lane loop adds its finished paths (acc = acc + rad from 0), so the
//     result is bit-equal to one thread per lane and to the plain version.
//   - The item pool. With one item a thread a warp still ran as long as its
//     longest item (13-258 iterations, mean 21.8, on the benchmark's
//     mass_cluster: 63 % of the loop iterations its warps issued did work),
//     and a block held its SM slot until its slowest warp ended. So a LOOPM
//     launch starts a resident grid (the blocks its SMs hold at once), each
//     thread takes item = its thread index first, and a thread whose item
//     ends (or is cut at the cap) writes that item's words at the item's
//     index and takes the next unclaimed one (pool_take) in the same loop
//     iteration, with a fresh state: the same stream ids, `it` from 0 under
//     the same cap, the same words, so fold_kernel and the film see what one
//     item a thread gave. A thread leaves the loop when the pool is empty;
//     no warp waits on a long item of another's but the launch's last ones.
//     A persistent pool lost on the item instantiations' paths (below),
//     whose warps ran nearly full; LOOPM's ran a third empty.
//   - The cap. A thread's cap is the whole lane's, max_iters of the call's
//     spp, so no sample is cut where the lane loop would not cut it. The
//     lane loop cuts where a lane's iteration sum passes that cap; a cut
//     sample's partial counts cannot be rebuilt, so fold_kernel counts such
//     lanes (over_cap) and the caller holds that count at 0. Bounds on one
//     path's iterations (a regeneration shares the first trace's
//     iteration; every iteration but a path's last traces):
//       geodesic: a near chord is taken while geo_steps <= max_steps and
//       adds one, so at most max_steps + 1 per path; at most max_bounces + 1
//       events scatter (one at bounce = max_bounces is still taken); one
//       iteration ends the path; a near chord that hits is both. A path
//       takes at most max_steps + max_bounces + 3 = per_path + 1
//       iterations (per_path = max_bounces + 2 + max_steps,
//       TraceConfig.max_iters). With spp >= 2 the cap per_path·spp holds
//       any one path, so no thread is cut; a lane loop is cut only if its
//       paths average more than per_path, which needs paths that spend both
//       budgets to the last step. With spp = 1 the thread is the lane loop.
//       geodesic in media: at each bounce level 0..max_bounces the lane
//       takes one surface-mode event (entering a medium, or leaving the
//       level by a scatter or an exit) and at most max_volume_bounces march
//       steps (taken while vbounce <= max_volume_bounces, from 1), the last
//       of which may leave the level; near chords are surface-mode only, at
//       most max_steps + 1; one more iteration ends the path. A path takes
//       at most (max_bounces + 1)(max_volume_bounces + 1) + max_steps + 2
//       iterations, max_bounces + max_volume_bounces + 1 under per_path =
//       (max_bounces + 2)(max_volume_bounces + 2) + max_steps: the cap
//       never binds.
//   - Every lane of a warp reads the same mass row at once, a shared-memory
//     broadcast without bank conflicts; the loop runs over the run-time
//     count with a partial unroll of 4 that keeps the order; only near
//     lanes take the RK4 step. The fold reads each word of a lane's
//     samples in order (n·spp·(n_out + 4) words once) and is bound by bytes.
//
// The item instantiations (unrolled masses and media without the BVH,
// kernels 1d, 1b and 1c: PER_ITEM without LOOPM):
//   - What held the lane loop back on their paths (blackhole, cloud,
//     dense_cloud, blackhole_cloud): each thread carried a fixed quota of 32
//     or 64 samples, with lanes up to 1.4-3.8x the mean length, in a launch
//     2.2-3.1 waves deep, and 93-119 registers left 16-20 warps per SM to
//     hide long dependent chains (the IEEE 1/sqrtf and divisions of every
//     RK4 stage, the 8-corner __ldg gather of every march step).
//   - So they run the LOOPM instantiations' split: one thread per (lane,
//     sample) item, the same stream ids, per-item words that fold_kernel
//     adds in order (bit-equal to one thread per lane), with no per-lane
//     accumulators in the loop, and a register budget,
//     __launch_bounds__(BLOCK, MIN_BLOCKS): 6 blocks of 128 per SM (80
//     registers) for geodesics or media, 5 (96) for both, that is 24 and 20
//     warps. ptxas spills a few words under it (20 B in FULL output, 8 B
//     with both; 150-210 B with the AOVs); the budget was faster than none
//     on every path, in FULL output and with the AOVs.
//   - The 32 threads of a warp trace 32 samples of one lane, whose paths are
//     alike under lensing. Persistent blocks that took items from a pool, a
//     warp's fetch at a time, lost to this on the geodesic paths: the warp's
//     threads drifted apart in their paths (PERF.md §6).
//   - The cap as for LOOPM: a path in media without geodesics takes at most
//     (max_bounces + 1)(max_volume_bounces + 1) + 2 iterations, under
//     per_path = (max_bounces + 2)(max_volume_bounces + 2): it never binds.
//
// Media (the VOL instantiation; ops/volume.py and trace_core's march mode
// are the order):
//   - One device function, density_sample, serves sparse and dense grids.
//     The TPU kernel needs two forms because Mosaic cannot gather: a scalar
//     unroll over the nonzero cells baked as constants (1b), and a bf16
//     one-hot brick contraction on the MXU (1c). Here the grid stack
//     [G,D,H,W] f32 arrives as its own global buffer (a 32^3 grid is 128 KiB,
//     too big for the shared-memory table) and each lookup reads its 8
//     corners through the read-only path (__ldg): a 16^3 grid (16 KiB) stays
//     in L1, a 32^3 one (128 KiB) mostly in L2. Staging it in shared memory is
//     later work. The weights are applied in the plain version's order (x, then
//     y, then z; a far corner clamped onto the near one gets the single
//     weight (1 - f) + f), so the kernel and the plain version agree bit for
//     bit; both differ from the reference's XLA einsum by at most ~2 ulp.
//   - Per-lane state: march (the three-state mode is alive x march),
//     vbounce and last_sph (a sphere row) are registers.
//   - What likely bounds it on this card: per march step a full primitive
//     sweep plus 8 dependent loads and ~54 FP32 operations of the lookup,
//     and divergence between march lanes and surface lanes of one warp
//     (a lane that crosses a cloud takes tens of march steps where its
//     neighbour takes one surface segment). Each thread runs its own loop
//     (one per item, above); it shades a volume event without the
//     surface-shading block and skips the lookup on surface events. Sorting
//     threads by mode is later work.
//   - The interior test |end - center|^2 <= r^2 sits on the sphere boundary;
//     it keeps length_squared's order. Knife-edge scatter decisions
//     (u0 < step * density) follow from the bit-equal density.

#include <cstdint>
#include <limits>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

// table layout (ops/trace_kernel.py::scene_table): row-major f32 blocks
constexpr int SPH_COLS = 15;         // center xyz, radius, mtype, color rgb, rough, ior, vol x4, valid
constexpr int RCT_COLS = 21;         // center, x, y, z (xyz each), hw, hh, mtype, color rgb, rough, ior, valid
constexpr int BOX_COLS = 28;         // normals 3x3, dlo, dhi, sgn_lo, sgn_hi (xyz), mtype, color rgb, rough, ior, valid
constexpr int LIGHT_HEAD = 5;        // kind, sphere center xyz, sphere radius
constexpr int LIGHT_FACE_COLS = 23;  // center, fx, fy, ux, uy, z (xyz), hw, hh, area, cdf, valid
// then the environment: root mtype, albedo rgb, emitted rgb
constexpr int ENV_FLOATS = 7;
constexpr int MASS_COLS = 4;         // center xyz, rs (after the environment)
constexpr int MAX_MASSES = 8;        // the geodesic instantiation's unroll

constexpr int MAT_FLAT = 0, MAT_DIFFUSE = 1, MAT_METALLIC = 2, MAT_GLASS = 3, MAT_EMISSIVE = 4;
constexpr int FACE_FRONT = 0, FACE_BACK = 1, FACE_VOLUME = 2, FACE_VOLUME_FRONT = 3,
              FACE_VOLUME_BACK = 4;

constexpr int FLAG_DIFFUSE = 1, FLAG_METALLIC = 2, FLAG_GLASS = 4, FLAG_DOF = 8, FLAG_POLY = 16,
              FLAG_GEO = 32, FLAG_LOOPM = 64, FLAG_GTAB = 128, FLAG_BVH = 256;
constexpr int N_COUNTS = 4;  // per-item counts: rays, iters, vevents, near_steps
// threads per block, every instantiation: a build parameter
// (-DBENDY_TRACE_BLOCK=n, bendy_tpu_torch/_build.py library(block=n); the
// host reads the same n from its build), 128 unless the build asks
#ifndef BENDY_TRACE_BLOCK
#define BENDY_TRACE_BLOCK 128
#endif
constexpr int BLOCK = BENDY_TRACE_BLOCK;
static_assert(BLOCK % 32 == 0 && BLOCK >= 32 && BLOCK <= 1024, "whole warps, at most 1024");

// the BVH node block (ops/bvh.py::build_bvh): a header, 8 floats per node,
// then the keys; the walk's stack of uint16 node indices in shared memory,
// BVH_STACK per thread, thread-major within a level (no bank conflicts)
constexpr int BVH_HEAD = 16, BVH_NODE = 8, BVH_STACK = 16, BVH_THREADS = BLOCK;
constexpr int H_NODES = 0, H_ALWAYS = 1, H_SPH = 2, H_RMAX = 3, H_KRB = 4, H_CABS = 5, H_MAG = 6,
              H_RT = 7, H_CENTER = 8;
constexpr size_t BVH_STACK_BYTES = sizeof(uint16_t) * BVH_STACK * BVH_THREADS;
constexpr float BVH_S0 = (float)1.2e-5, BVH_E4U = (float)(4.0 / 16777216.0);
constexpr float BVH_S_MAX = (float)0.01, BVH_T_GROWTH = (float)1.02;

constexpr uint32_t CAMERA_TAG = 0x100000u;
constexpr float INF = std::numeric_limits<float>::infinity();
constexpr float PI_F = (float)3.14159265358979323846;
constexpr float EPS_PAR = (float)1e-5;
constexpr float SCATTER_ALBEDO = (float)0.8;  // volume.rs:38-53

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 normalize(V3 a) { return a * (1.0f / sqrtf(dot(a, a))); }
__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }

// PER_ITEM: n lanes and spp samples give n·spp items, and out, rays, iters,
// vevents and near_steps are per item ([n_out, n·spp], [n·spp])
struct Params {
  const float* table;  // global copy; staged into shared memory unless FLAG_GTAB
  const float* cam;    // packed camera [32] (trace_kernel.pack_camera_host)
  const int32_t* pix;
  const int32_t* sub;
  float* out;          // [n_out, n] channel-major
  int32_t* rays;       // [n]
  int32_t* iters;      // [n]
  int n, table_floats;
  int width, height, spp, subsample;
  uint32_t spp_total, key0, key1, sample0;
  int max_bounces, max_iters, flags;
  float clip_min, clip_max, dep_den;  // dep_den = f32(clip_max - clip_min) in double
  float pw, ph, pw_n, ph_n;            // f32(2/W), f32(2/H), f32(2/W/n), f32(2/H/n)
  int n_sph, n_rct, n_box, n_light, n_face;
  int n_mass, max_steps;                         // geodesic instantiation only
  float eta, min_step, max_step, far, growth;    // GeoParams
  const float* grid;                             // volume instantiation only: [G,D,H,W]
  int32_t* vevents;                              // [n] volume events per lane
  int G, D, H, W;
  float volume_step;
  int max_volume_bounces, nearest;
  int32_t* near_steps;                           // geodesics, optional: RK4 steps per item
  int bvh0;                                      // BVH only: the node block's offset in the table
  int32_t* bvh_tests;                            // BVH only, optional: [2, n] node, prim tests
  unsigned long long* loop_use;                  // optional: [2] warp use (count_warp_use)
  unsigned* lane_next;  // the lane pool only: its draws' counter, zeroed on the launch's stream
};

// ---- RNG (utils/rng.py) -------------------------------------------------

__device__ __forceinline__ void pcg4d(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
  const uint32_t m = 1664525u, inc = 1013904223u;
  a = a * m + inc;
  b = b * m + inc;
  c = c * m + inc;
  d = d * m + inc;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
  a ^= a >> 16;
  b ^= b >> 16;
  c ^= c >> 16;
  d ^= d >> 16;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
}

__device__ __forceinline__ float unit_float(uint32_t w) {
  return (float)(w >> 8) * (float)(1.0 / 16777216.0);
}

// four uniforms of lane_uniforms(key, sid, tag, n) block `block`
__device__ __forceinline__ void uniforms4(uint32_t sid, uint32_t tag, uint32_t block, uint32_t k0,
                                          uint32_t k1, float u[4]) {
  uint32_t a = sid, b = tag * 16u + block, c = k0, d = k1;
  pcg4d(a, b, c, d);
  u[0] = unit_float(a);
  u[1] = unit_float(b);
  u[2] = unit_float(c);
  u[3] = unit_float(d);
}

// ---- distributions (ops/distr.py) ---------------------------------------

__device__ __forceinline__ void sin_cos_tau(float u, float& s, float& c) {
  float h = (u - 0.5f) * PI_F;
  float h2 = h * h;
  float s_h = h * (1.0f + h2 * ((float)(-1.0 / 6.0) +
                                h2 * ((float)(1.0 / 120.0) +
                                      h2 * ((float)(-1.0 / 5040.0) + h2 * (float)(1.0 / 362880.0)))));
  float c_h = 1.0f + h2 * (-0.5f + h2 * ((float)(1.0 / 24.0) +
                                         h2 * ((float)(-1.0 / 720.0) +
                                               h2 * ((float)(1.0 / 40320.0) +
                                                     h2 * (float)(-1.0 / 3628800.0)))));
  s = -2.0f * s_h * c_h;
  c = 2.0f * (s_h * s_h) - 1.0f;
}

__device__ __forceinline__ void sin_cos_small(float x, float& s, float& c) {
  float x2 = x * x;
  s = x * (1.0f + x2 * ((float)(-1.0 / 6.0) +
                        x2 * ((float)(1.0 / 120.0) +
                              x2 * ((float)(-1.0 / 5040.0) + x2 * (float)(1.0 / 362880.0)))));
  c = 1.0f + x2 * (-0.5f + x2 * ((float)(1.0 / 24.0) +
                                 x2 * ((float)(-1.0 / 720.0) +
                                       x2 * ((float)(1.0 / 40320.0) +
                                             x2 * (float)(-1.0 / 3628800.0)))));
}

// branchless tangent frame (Duff et al. 2017), utils/v3.py::orthonormal_frame
__device__ __forceinline__ void frame(V3 n, V3& t, V3& b) {
  float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sign + n.z);
  float bb = n.x * n.y * a;
  t = {1.0f + sign * n.x * n.x * a, sign * bb, -sign * n.x};
  b = {bb, sign + n.y * n.y * a, -n.y};
}

__device__ __forceinline__ V3 unit_sphere(float u1, float u2) {
  float s1, c1;
  sin_cos_tau(u1, s1, c1);
  float s = 2.0f * sqrtf(u2 * (1.0f - u2));
  return {c1 * s, s1 * s, 1.0f - 2.0f * u2};
}

__device__ __forceinline__ V3 unit_hemisphere(V3 n, float u1, float u2) {
  float s1, c1;
  sin_cos_tau(u1, s1, c1);
  float s = 2.0f * sqrtf(u2 * (1.0f - u2));
  V3 t, b;
  frame(n, t, b);
  return t * (c1 * s) + b * (s1 * s) + n * (1.0f - u2);
}

__device__ __forceinline__ V3 cosine_hemisphere(V3 n, float u1, float u2) {
  float s1, c1;
  sin_cos_tau(u1, s1, c1);
  float sq = sqrtf(u2);
  V3 t, b;
  frame(n, t, b);
  return t * (c1 * sq) + b * (s1 * sq) + n * sqrtf(1.0f - u2);
}

// ---- BSDF vector math (utils/v3.py) -------------------------------------

__device__ __forceinline__ V3 reflect(V3 d, V3 n) { return d - n * (2.0f * dot(d, n)); }

__device__ __forceinline__ V3 refract(V3 d, V3 n, float ior) {
  float cos_theta = fminf(dot(-d, n), 1.0f);
  V3 perp = (n * cos_theta + d) * ior;
  V3 parallel = n * -sqrtf(fabsf(1.0f - dot(perp, perp)));
  return perp + parallel;
}

__device__ __forceinline__ float fresnel(V3 d, V3 n, float ior) {
  float cos_theta = fminf(dot(-d, n), 1.0f);
  float r0 = (1.0f - ior) / (1.0f + ior);
  r0 = r0 * r0;
  float c = 1.0f - cos_theta;
  float c2 = c * c;
  return r0 + (1.0f - r0) * (c * (c2 * c2));
}

// ---- intersection (ops/intersect.py) ------------------------------------

__device__ __forceinline__ float sphere_t(V3 org, V3 dir, float cmin, float cmax, V3 center,
                                          float radius) {
  V3 oc = org - center;
  float half_b = dot(oc, dir);
  float c = dot(oc, oc) - radius * radius;
  float disc = half_b * half_b - c;
  if (!(disc >= 0.0f)) return INF;
  float sq = sqrtf(disc);
  float t_near = -half_b - sq;
  float t_far = -half_b + sq;
  if (t_near >= cmin && t_near <= cmax) return t_near;
  if (t_far >= cmin && t_far <= cmax) return t_far;
  return INF;
}

// t (+INF on miss); p = (c-o)·n, whose sign says the side
__device__ __forceinline__ float rect_t(V3 org, V3 dir, float cmin, float cmax, V3 center, V3 xb,
                                        V3 yb, V3 zb, float hw, float hh, float& p) {
  float q = dot(dir, zb);
  p = dot(center - org, zb);
  float q_safe = fabsf(q) <= EPS_PAR ? 1.0f : q;
  float t = p / q_safe;
  V3 local = (org + dir * t) - center;
  float lx = dot(local, xb);
  float ly = dot(local, yb);
  bool ok = fabsf(q) > EPS_PAR && t >= cmin && t <= cmax && lx * lx <= hw * hw && ly * ly <= hh * hh;
  return ok ? t : INF;
}

// three-slab box (ops/intersect.py::box_t): t, p_sign (<0 = front) and
// the normal the rect manifold expects
__device__ __forceinline__ float box_t(V3 org, V3 dir, float cmin, float cmax, const float* row,
                                       float& p_sign, V3& zb_like) {
  float tnear = -INF, tfar = INF;
  V3 near_n = {0.0f, 0.0f, 0.0f}, far_n = {0.0f, 0.0f, 0.0f};
  float fr_near = 1.0f, fr_far = 1.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    V3 n_i = ld3(row + 3 * i);
    float dlo = row[9 + i], dhi = row[12 + i];
    float slo = row[15 + i], shi = row[18 + i];
    float q = dot(dir, n_i);
    float p = dot(org, n_i);
    bool par = fabsf(q) <= EPS_PAR;
    float inv = 1.0f / (par ? 1.0f : q);
    float t1 = (dlo - p) * inv;
    float t2 = (dhi - p) * inv;
    float tno = fminf(t1, t2);
    float tfo = fmaxf(t1, t2);
    if (par) {
      // parallel: between the planes -> slab is unbounded, else empty
      bool inside = p >= dlo && p <= dhi;
      tno = inside ? -INF : INF;
      tfo = inside ? INF : -INF;
    }
    bool pos_q = q > 0.0f;
    V3 oriented = n_i * (pos_q ? -1.0f : 1.0f);
    if (tno > tnear) {
      tnear = tno;
      near_n = oriented;
      fr_near = pos_q ? slo : -shi;
    }
    if (tfo < tfar) {
      tfar = tfo;
      far_n = oriented;
      fr_far = pos_q ? shi : -slo;
    }
  }
  bool nonempty = tnear <= tfar;
  bool near_ok = nonempty && tnear >= cmin && tnear <= cmax;
  bool far_ok = nonempty && tfar >= cmin && tfar <= cmax;
  p_sign = near_ok ? fr_near : fr_far;
  zb_like = (near_ok ? near_n : far_n) * (-p_sign);
  return near_ok ? tnear : (far_ok ? tfar : INF);
}

struct Hit {
  float t;
  V3 position, normal;
  int face, mtype;
  V3 color;  // merged: emitted for Flat/Emissive, albedo otherwise
  float rough, ior;
};

// the volume instantiation's hit: also the winning sphere's grid, row and box
struct VolHit : Hit {
  int vgrid, srow;
  V3 vsize, center;
  float radius;
};

template <bool VOL>
using HitT = typename std::conditional<VOL, VolHit, Hit>::type;

// a march step's end point org + dir·cmax still inside sphere `row`
// (|end - center|² <= r², in length_squared's order)
__device__ __forceinline__ bool ends_inside(V3 org, V3 dir, float cmax, const float* row) {
  const V3 e = (org + dir * cmax) - ld3(row);
  return dot(e, e) <= row[3] * row[3];
}

// the Hit of a winner (`win`, a row of kind 0 sphere, 1 rect, 2 box, or
// nullptr on a miss), with the rect / box manifold carries c_p, c_zb
template <bool VOL>
__device__ __forceinline__ HitT<VOL> hit_record(const float* tab, float t_best, const float* win,
                                                int kind, float c_p, V3 c_zb, float cmax, V3 org,
                                                V3 dir, bool march, int last_sph) {
  HitT<VOL> h;
  h.t = t_best;
  h.face = -1;
  h.mtype = 0;
  h.position = org + dir * t_best;
  h.normal = {0.0f, 0.0f, 0.0f};
  h.color = {0.0f, 0.0f, 0.0f};
  h.rough = 0.0f;
  h.ior = 1.0f;
  if (win == nullptr) return h;
  if (kind == 0) {
    // sphere manifold (sphere.rs:85-119)
    float r = win[3];
    V3 c = ld3(win);
    V3 n = {(h.position.x - c.x) / r, (h.position.y - c.y) / r, (h.position.z - c.z) / r};
    bool front = dot(dir, n) < 0.0f;
    h.normal = front ? n : -n;
    h.face = front ? FACE_FRONT : FACE_BACK;
    h.mtype = (int)win[4];
    h.color = ld3(win + 5);
    h.rough = win[8];
    h.ior = win[9];
    if constexpr (VOL) {
      // volume faces (sphere.rs:71-83, 150-166); the interior pseudo-hit
      // is the last sphere winning while the step ends inside it
      h.srow = (int)((win - tab) / SPH_COLS);
      h.vgrid = (int)win[10];
      if (h.vgrid >= 0) h.face = front ? FACE_VOLUME_FRONT : FACE_VOLUME_BACK;
      if (march && h.srow == last_sph && ends_inside(org, dir, cmax, win)) {
        h.normal = {0.0f, 0.0f, 0.0f};
        h.face = FACE_VOLUME;
      }
      h.vsize = ld3(win + 11);
      h.center = c;
      h.radius = r;
    }
  } else {
    // rect manifold (rect.rs:138-142); boxes share it
    bool front = c_p < 0.0f;
    h.normal = front ? c_zb : -c_zb;
    h.face = front ? FACE_FRONT : FACE_BACK;
    int m = kind == 1 ? 14 : 21;
    h.mtype = (int)win[m];
    h.color = ld3(win + m + 1);
    h.rough = win[m + 4];
    h.ior = win[m + 5];
    if constexpr (VOL) h.vgrid = -1;
  }
  return h;
}

// ---- the sweep over float4 rows (kernels 1a and 1d) -----------------------
//
// The surface and geodesic instantiations that stage the table (SWEEP_ROWS:
// no media, BVH or GTAB; LOOPM among them) sweep rows of their own, built by
// the block's staging loop in front of the staged table: only the fields a test
// reads, each row a run of float4s, so that a row is read with 16-byte
// shared loads (every lane of a warp reads the same row: a broadcast) where
// the flat rows, 15, 21 and 28 floats wide, take one 32-bit load a field:
//   sphere [4]:  center xyz, radius
//   rect  [16]:  center xyz, hw | zb xyz, hh | xb xyz, 0 | yb xyz, 0
//   box   [16]:  n0 xyz, dlo0 | n1 xyz, dlo1 | n2 xyz, dlo2 | dhi xyz, 0
// A box's sgn_lo / sgn_hi and every shading field are read from the flat
// row of the winner alone, after the sweep. The arithmetic is the flat
// sweep's, operation for operation, so the winner, its t and its manifold
// are bit for bit the same. A geodesic chord's clip is short, [0 or
// clip_min, |chord|], so nearly every rect test of a chord rejects, and the
// 32 threads of a warp (32 samples of one pixel) reject together. The host
// (bendy_staged_floats, bendy_item_occupancy) asks the same rule,
// sweeps_rows, with the table staged.
__host__ __device__ constexpr bool sweeps_rows(bool vol, bool gtab, bool bvh) {
  return !vol && !gtab && !bvh;
}
template <bool VOL, bool GTAB, bool BVH>
constexpr bool SWEEP_ROWS = sweeps_rows(VOL, GTAB, BVH);
constexpr int SPH_ROW = 4, RCT_ROW = 16, BOX_ROW = 16;

__host__ __device__ __forceinline__ int sweep_rows_floats(int n_sph, int n_rct, int n_box) {
  return SPH_ROW * n_sph + RCT_ROW * n_rct + BOX_ROW * n_box;
}

// whether t = p / q, correctly rounded, may still pass t >= cmin, t <= cmax
// and t < t_best; false only where it cannot. a = p · rcp.approx(q) lies
// within 2^-21.4·|p/q| + 2^-149 of the rounded t (rcp.approx.f32: 1 ulp,
// taken as 2; the product and the rounding of p / q: half an ulp each), and
// the margin m = |a|·2^-20 + 2^-126 covers that and the rounding of a ± m;
// an a that overflows makes a - m NaN, which rejects nothing
__device__ __forceinline__ float rcp_approx(float q) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(q));
  return r;
}
constexpr float REJECT_REL = (float)(1.0 / 1048576.0), REJECT_ABS = (float)1.1754943508222875e-38;
__device__ __forceinline__ bool quotient_may_win(float a, float cmin, float cmax, float t_best) {
  const float m = fabsf(a) * REJECT_REL + REJECT_ABS;
  return !(a + m < cmin || a - m > cmax || a - m >= t_best);
}

#ifdef BENDY_SWEEP_STATS
// the measuring build (tools/sweep_sass.py, -DBENDY_SWEEP_STATS): the lane
// rect tests, the tests whose lane could skip its division (`may` false)
// and the tests whose whole warp could
__device__ unsigned long long sweep_stats[3];
__device__ __forceinline__ void sweep_count(bool may) {
  const unsigned active = __activemask();
  const unsigned want = __ballot_sync(active, may);
  if ((threadIdx.x & 31) == __ffs(active) - 1) {
    const unsigned long long lanes = __popc(active);
    atomicAdd(&sweep_stats[0], lanes);
    atomicAdd(&sweep_stats[1], lanes - __popc(want));
    if (want == 0) atomicAdd(&sweep_stats[2], lanes);
  }
}
#endif

// word e of the sweep rows, from the flat table
__device__ __forceinline__ float sweep_row_word(const float* table, int n_sph, int n_rct, int e) {
  if (e < SPH_ROW * n_sph) return table[(e / SPH_ROW) * SPH_COLS + e % SPH_ROW];
  e -= SPH_ROW * n_sph;
  const float* flat = table + n_sph * SPH_COLS;
  int cols = RCT_COLS, k = e / RCT_ROW;
  const int w = (e % RCT_ROW) / 4, i = e % 4;
  int col;  // the flat column of float i of row word w; -1: the pad
  if (k < n_rct) {  // center 0-2, hw 12 | zb 9-11, hh 13 | xb 3-5 | yb 6-8
    const int xyz = w == 0 ? 0 : w == 1 ? 9 : w == 2 ? 3 : 6;
    col = i < 3 ? xyz + i : w == 0 ? 12 : w == 1 ? 13 : -1;
  } else {  // slab w's normal 3w..3w+2 and dlo 9+w | dhi 12-14
    flat += n_rct * RCT_COLS;
    cols = BOX_COLS;
    k -= n_rct;
    col = i < 3 ? (w < 3 ? 3 * w : 12) + i : w < 3 ? 9 + w : -1;
  }
  return col < 0 ? 0.0f : flat[k * cols + col];
}

// box_t over a row: t (+INF on miss), and for the manifold the slab whose
// plane gives t, the sign of its q and whether it is the near plane
__device__ __forceinline__ float box_t_row(V3 org, V3 dir, float cmin, float cmax, const float4* r,
                                           int& slab, bool& pos, bool& near) {
  float tnear = -INF, tfar = INF;
  int i_near = 0, i_far = 0;
  bool q_near = false, q_far = false;
  const float4 hi = r[3];
  const float dhis[3] = {hi.x, hi.y, hi.z};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 v = r[i];
    const float dlo = v.w, dhi = dhis[i];
    float q = dot(dir, V3{v.x, v.y, v.z});
    float p = dot(org, V3{v.x, v.y, v.z});
    bool par = fabsf(q) <= EPS_PAR;
    float inv = 1.0f / (par ? 1.0f : q);
    float t1 = (dlo - p) * inv;
    float t2 = (dhi - p) * inv;
    float tno = fminf(t1, t2);
    float tfo = fmaxf(t1, t2);
    if (par) {
      bool inside = p >= dlo && p <= dhi;
      tno = inside ? -INF : INF;
      tfo = inside ? INF : -INF;
    }
    bool pos_q = q > 0.0f;
    if (tno > tnear) {
      tnear = tno;
      i_near = i;
      q_near = pos_q;
    }
    if (tfo < tfar) {
      tfar = tfo;
      i_far = i;
      q_far = pos_q;
    }
  }
  bool nonempty = tnear <= tfar;
  bool near_ok = nonempty && tnear >= cmin && tnear <= cmax;
  bool far_ok = nonempty && tfar >= cmin && tfar <= cmax;
  near = near_ok;
  slab = near_ok ? i_near : i_far;
  pos = near_ok ? q_near : q_far;
  return near_ok ? tnear : (far_ok ? tfar : INF);
}

// nearest_hit over the sweep rows in front of `tab`: spheres, rects, then
// boxes, a later primitive winning only on a strictly smaller t
__device__ __forceinline__ Hit nearest_hit_rows(const float* tab, int n_sph, int n_rct, int n_box,
                                                float cmin, float cmax, V3 org, V3 dir) {
  const float4* r = reinterpret_cast<const float4*>(tab - sweep_rows_floats(n_sph, n_rct, n_box));
  float t_best = INF;
  int kind = -1, win = 0;  // the winner: 0 sphere, 1 rect, 2 box, and its row
  float c_p = 0.0f;
  V3 c_zb = {0.0f, 0.0f, 0.0f};
  int w_slab = 0;
  bool w_pos = false, w_near = false;
  for (int k = 0; k < n_sph; ++k, ++r) {
    const float4 s = *r;
    const float t = sphere_t(org, dir, cmin, cmax, V3{s.x, s.y, s.z}, s.w);
    if (t < t_best) {
      t_best = t;
      kind = 0;
      win = k;
    }
  }
  for (int k = 0; k < n_rct; ++k, r += RCT_ROW / 4) {
    const float4 a = r[0], b = r[1];
    const V3 center = {a.x, a.y, a.z}, zb = {b.x, b.y, b.z};
    // rect_t in its order, its division and containment test only where t
    // may still win
    const float q = dot(dir, zb);
    const float p = dot(center - org, zb);
    const bool may = fabsf(q) > EPS_PAR && quotient_may_win(p * rcp_approx(q), cmin, cmax, t_best);
#ifdef BENDY_SWEEP_STATS
    sweep_count(may);
#endif
    if (may) {
      const float4 c = r[2], d = r[3];
      const float t = p / q;
      const V3 local = (org + dir * t) - center;
      const float lx = dot(local, V3{c.x, c.y, c.z});
      const float ly = dot(local, V3{d.x, d.y, d.z});
      if (t >= cmin && t <= cmax && lx * lx <= a.w * a.w && ly * ly <= b.w * b.w && t < t_best) {
        t_best = t;
        kind = 1;
        win = k;
        c_p = p;
      }
    }
  }
  for (int k = 0; k < n_box; ++k, r += BOX_ROW / 4) {
    int slab;
    bool pos, near;
    const float t = box_t_row(org, dir, cmin, cmax, r, slab, pos, near);
    if (t < t_best) {
      t_best = t;
      kind = 2;
      win = k;
      w_slab = slab;
      w_pos = pos;
      w_near = near;
    }
  }
  const float* row = nullptr;
  if (kind == 0) row = tab + win * SPH_COLS;
  if (kind == 1) {
    row = tab + n_sph * SPH_COLS + win * RCT_COLS;
    c_zb = ld3(row + 9);
  }
  if (kind == 2) {
    // box_t's p_sign and zb_like from the winning slab's row fields
    row = tab + n_sph * SPH_COLS + n_rct * RCT_COLS + win * BOX_COLS;
    const float slo = row[15 + w_slab], shi = row[18 + w_slab];
    c_p = w_near ? (w_pos ? slo : -shi) : (w_pos ? shi : -slo);
    c_zb = (ld3(row + 3 * w_slab) * (w_pos ? -1.0f : 1.0f)) * (-c_p);
  }
  return hit_record<false>(tab, t_best, row, kind < 0 ? 0 : kind, c_p, c_zb, cmax, org, dir,
                           false, -1);
}

// ---- the BVH walk (ops/bvh.py) -------------------------------------------
//
// The BVH instantiations (FLAG_BVH: the looped-sweep scenes, past
// render.LOOP_SWEEP_THRESHOLD primitives, without geodesics) find the
// sweep's nearest hit by walking a tree of boxes over the primitives
// instead of testing every row. The sweep keeps the first row with the
// smallest t: the lexicographic least (t, key) over all primitives, key =
// sphere row, then n_sph + rect row, then n_sph + n_rct + box row. The walk
// tests each primitive it reaches with the same sphere_t / rect_t / box_t
// and the lane's own clip and keeps the least (t, key), which does not
// depend on the order of the tests, so it finds the same winner with the
// same t bit for bit provided it skips only subtrees that hold no candidate.
// A node is skipped when its box, padded by the per-ray distance of
// ops/bvh.py (an error bound of the f32 tests: a sphere test reports points
// up to ~sqrt(|dir|² - 1)·t outside the sphere, since the half-b quadratic
// assumes a unit direction), misses [cmin, min(cmax, t_best)].
//
// What bounds it on this card: the latency of the dependent node loads and
// the stack, and divergence between lanes whose walks differ in length.
// The design tests both children of an inner node at once (two independent
// box tests), goes on to the one the segment enters first and pushes the
// other, so t_best shrinks early and far subtrees are culled, never pushes
// a child the segment misses, tests a popped node's box again against the
// shrunk t_best, and keeps the stack in shared memory (uint16 node
// indices, BVH_STACK per thread), not in a local array that would spill.

// a node's padding in t along each axis for a search up to tlim
// (ops/bvh.py::pad_for)
struct BvhPad {
  float x, y, z;
};

__device__ __forceinline__ BvhPad bvh_pad(V3 inv, float pad0, float pad1, float t_a, float tlim) {
  const float pad = pad0 + pad1 * fminf(tlim, t_a);
  return {pad * fabsf(inv.x), pad * fabsf(inv.y), pad * fabsf(inv.z)};
}

// whether the segment [cmin, tlim] meets node `nd`'s box padded by tp, its
// entry t and the node's last two words (ops/bvh.py::node_visit)
__device__ __forceinline__ bool bvh_node(const float* nd, V3 org, V3 inv, BvhPad tp, float cmin,
                                         float tlim, float& tn, float& z, float& w) {
  const float4 a = *reinterpret_cast<const float4*>(nd);
  const float4 b = *reinterpret_cast<const float4*>(nd + 4);
  const float t0x = (a.x - org.x) * inv.x, t1x = (a.w - org.x) * inv.x;
  const float t0y = (a.y - org.y) * inv.y, t1y = (b.x - org.y) * inv.y;
  const float t0z = (a.z - org.z) * inv.z, t1z = (b.y - org.z) * inv.z;
  tn = fmaxf(fmaxf(fminf(t0x, t1x) - tp.x, fminf(t0y, t1y) - tp.y), fminf(t0z, t1z) - tp.z);
  const float tf = fminf(fminf(fmaxf(t0x, t1x) + tp.x, fmaxf(t0y, t1y) + tp.y),
                         fmaxf(t0z, t1z) + tp.z);
  z = b.z;
  w = b.w;
  return !(tn > fminf(tf, tlim) || tf < cmin);
}

// primitive `key`'s t with the lane's clip, and the rect / box manifold
// carries (ops/bvh.py::_prim_t)
__device__ __forceinline__ float bvh_prim_t(const float* tab, int n_sph, int n_rct, int key, V3 org,
                                            V3 dir, float cmin, float cmax, float& p, V3& zb,
                                            const float*& row, int& kind) {
  if (key < n_sph) {
    row = tab + key * SPH_COLS;
    kind = 0;
    return sphere_t(org, dir, cmin, cmax, ld3(row), row[3]);
  }
  if (key < n_sph + n_rct) {
    row = tab + n_sph * SPH_COLS + (key - n_sph) * RCT_COLS;
    kind = 1;
    zb = ld3(row + 9);
    return rect_t(org, dir, cmin, cmax, ld3(row), ld3(row + 3), ld3(row + 6), zb, row[12],
                  row[13], p);
  }
  row = tab + n_sph * SPH_COLS + n_rct * RCT_COLS + (key - n_sph - n_rct) * BOX_COLS;
  kind = 2;
  return box_t(org, dir, cmin, cmax, row, p, zb);
}

// nearest_hit by the walk: the march pseudo-hit of the lane's last sphere
// first (outside any culling; that sphere is skipped where the walk meets
// it), then the always-tested keys, then the tree.
// Counts the node boxes and primitives tested (the winner's manifold, one
// more primitive test, not counted).
template <bool VOL>
__device__ __forceinline__ HitT<VOL> nearest_hit_bvh(const float* tab, int n_sph, int n_rct,
                                                     const float* bvh, uint16_t* stack,
                                                     float cmin, float cmax, V3 org, V3 dir,
                                                     bool march, int last_sph, int& node_tests,
                                                     int& prim_tests) {
  const int n_node = (int)bvh[H_NODES], n_always = (int)bvh[H_ALWAYS];
  const float* nodes = bvh + BVH_HEAD;
  const float* keys = nodes + BVH_NODE * n_node;
  float t_best = INF;
  int k_best = -1;
  auto consider = [&](int key) {
    float p;
    V3 zb;
    const float* row;
    int kind;
    const float t = bvh_prim_t(tab, n_sph, n_rct, key, org, dir, cmin, cmax, p, zb, row, kind);
    if (t < t_best || (t == t_best && key < k_best)) {
      t_best = t;
      k_best = key;
    }
  };
  bool skip_last = false;  // a marching lane's last sphere is tested here only
  if constexpr (VOL) {
    if (march && last_sph >= 0) {
      skip_last = true;
      const float* row = tab + last_sph * SPH_COLS;
      float t = sphere_t(org, dir, cmin, cmax, ld3(row), row[3]);
      if (ends_inside(org, dir, cmax, row)) t = cmax;
      ++prim_tests;
      if (t < t_best || (t == t_best && last_sph < k_best)) {
        t_best = t;
        k_best = last_sph;
      }
    }
  }
  for (int i = 0; i < n_always; ++i) {
    const int key = (int)keys[i];
    if (skip_last && key == last_sph) continue;
    ++prim_tests;
    consider(key);
  }
  if (n_node > 0) {
    // per-ray constants (ops/bvh.py::ray_setup)
    const V3 inv = {1.0f / dir.x, 1.0f / dir.y, 1.0f / dir.z};
    const float dd = dot(dir, dir);
    const float s =
        bvh[H_SPH] != 0.0f ? sqrtf(BVH_S0 + (fabsf(dd - 1.0f) + BVH_E4U) * 3.0f) : 0.0f;
    const float absorg = (fabsf(org.x) + fabsf(org.y)) + fabsf(org.z);
    const float dist = (fabsf(org.x - bvh[H_CENTER]) + fabsf(org.y - bvh[H_CENTER + 1])) +
                       fabsf(org.z - bvh[H_CENTER + 2]);
    const float q = bvh[H_CABS] * (absorg + bvh[H_MAG]);
    const float pad0 = s * bvh[H_RMAX] + q;
    const float pad1 = s + bvh[H_KRB];
    const float t_a = s <= BVH_S_MAX ? (dist + (bvh[H_RT] + q)) * BVH_T_GROWTH : INF;
    BvhPad tp = bvh_pad(inv, pad0, pad1, t_a, fminf(cmax, t_best));
    // the current node (one whose box the segment meets) and its last two
    // words: an inner node's right child and -1, a leaf's first key and
    // count
    int node = 0, sp = 0;
    float tn, cur_z, cur_w;
    ++node_tests;
    bool at = bvh_node(nodes, org, inv, tp, cmin, fminf(cmax, t_best), tn, cur_z, cur_w);
    while (at) {
      if (cur_w > 0.0f) {  // a leaf: keys [first, first + count)
        const int first = (int)cur_z, count = (int)cur_w;
        const float before = t_best;
        for (int j = 0; j < count; ++j) {
          const int key = (int)keys[first + j];
          if (skip_last && key == last_sph) continue;
          ++prim_tests;
          consider(key);
        }
        if (t_best != before) tp = bvh_pad(inv, pad0, pad1, t_a, fminf(cmax, t_best));
      } else {  // inner: both children's boxes, the one entered first visited first
        const int left = node + 1, right = (int)cur_z;
        const float tlim = fminf(cmax, t_best);
        float tn_l, tn_r, z_l, w_l, z_r, w_r;
        const bool v_l =
            bvh_node(nodes + BVH_NODE * left, org, inv, tp, cmin, tlim, tn_l, z_l, w_l);
        const bool v_r =
            bvh_node(nodes + BVH_NODE * right, org, inv, tp, cmin, tlim, tn_r, z_r, w_r);
        node_tests += 2;
        if (v_l || v_r) {
          const bool l_first = tn_l <= tn_r;
          if (v_l && v_r) stack[BVH_THREADS * sp++] = (uint16_t)(l_first ? right : left);
          const bool go_l = v_l && (!v_r || l_first);
          node = go_l ? left : right;
          cur_z = go_l ? z_l : z_r;
          cur_w = go_l ? w_l : w_r;
          continue;
        }
      }
      // pop until a node's box still meets the segment: t_best may have
      // shrunk since it was pushed
      at = false;
      while (sp > 0) {
        node = stack[BVH_THREADS * --sp];
        ++node_tests;
        if (bvh_node(nodes + BVH_NODE * node, org, inv, tp, cmin, fminf(cmax, t_best), tn, cur_z,
                     cur_w)) {
          at = true;
          break;
        }
      }
    }
  }
  const float* win = nullptr;
  int kind = 0;
  float c_p = 0.0f;
  V3 c_zb = {0.0f, 0.0f, 0.0f};
  if (k_best >= 0) {
    float p;
    V3 zb;
    bvh_prim_t(tab, n_sph, n_rct, k_best, org, dir, cmin, cmax, p, zb, win, kind);
    if (kind != 0) {
      c_p = p;
      c_zb = zb;
    }
  }
  return hit_record<VOL>(tab, t_best, win, kind, c_p, c_zb, cmax, org, dir, march, last_sph);
}

// the BVH instantiations' walk state, an empty struct in the others (their
// nearest_hit then compiles to the same code as before the BVH existed:
// ptxas reports the same registers): the node block, the thread's stack,
// and its counts of node and primitive tests
template <bool BVH>
struct BvhState {};
template <>
struct BvhState<true> {
  const float* bvh = nullptr;
  uint16_t* stack = nullptr;
  int node_tests = 0, prim_tests = 0;
};

// nearest hit over spheres, traced rects, then boxes; a later primitive wins
// only on a strictly smaller t (ops/intersect.py::nearest_hit + _manifold).
// VOL: a marching lane's last sphere reports an interior VOLUME pseudo-hit
// at t = cmax while the step's end point is still inside it; every volume
// addition sits in an `if constexpr (VOL)` block, so the other
// instantiations compile as before media existed. BVH: the walk instead
// (nearest_hit_bvh), with the same winner. ROWS: the sweep over the float4
// rows (nearest_hit_rows), with the same winner.
template <bool VOL, bool BVH = false, bool ROWS = false>
__device__ __forceinline__ HitT<VOL> nearest_hit(const float* tab, int n_sph, int n_rct,
                                                 int n_box, float cmin, float cmax, V3 org,
                                                 V3 dir, bool march, int last_sph,
                                                 BvhState<BVH>& walk) {
  if constexpr (BVH) {
    return nearest_hit_bvh<VOL>(tab, n_sph, n_rct, walk.bvh, walk.stack, cmin, cmax, org, dir,
                                march, last_sph, walk.node_tests, walk.prim_tests);
  }
  if constexpr (ROWS) return nearest_hit_rows(tab, n_sph, n_rct, n_box, cmin, cmax, org, dir);
  float t_best = INF;
  const float* win = nullptr;
  int kind = 0;  // 0 sphere, 1 rect, 2 box
  float c_p = 0.0f;
  V3 c_zb = {0.0f, 0.0f, 0.0f};
  const float* row = tab;
  for (int k = 0; k < n_sph; ++k, row += SPH_COLS) {
    float t = sphere_t(org, dir, cmin, cmax, ld3(row), row[3]);
    if constexpr (VOL) {
      if (march && k == last_sph && ends_inside(org, dir, cmax, row)) t = cmax;
    }
    if (t < t_best) {
      t_best = t;
      win = row;
      kind = 0;
    }
  }
  for (int k = 0; k < n_rct; ++k, row += RCT_COLS) {
    float p;
    float t = rect_t(org, dir, cmin, cmax, ld3(row), ld3(row + 3), ld3(row + 6), ld3(row + 9),
                     row[12], row[13], p);
    if (t < t_best) {
      t_best = t;
      win = row;
      kind = 1;
      c_p = p;
      c_zb = ld3(row + 9);
    }
  }
  for (int k = 0; k < n_box; ++k, row += BOX_COLS) {
    float p_sign;
    V3 zb_like;
    float t = box_t(org, dir, cmin, cmax, row, p_sign, zb_like);
    if (t < t_best) {
      t_best = t;
      win = row;
      kind = 2;
      c_p = p_sign;
      c_zb = zb_like;
    }
  }
  return hit_record<VOL>(tab, t_best, win, kind, c_p, c_zb, cmax, org, dir, march, last_sph);
}

// ---- lights (ops/materials.py::sample_light_point, intersect.light_pdf) --

__device__ __forceinline__ V3 sample_light_point(const float* lrow, int n_face, float u_a, float u_b, float u_face) {
  if (lrow[0] == 0.0f) return ld3(lrow + 1) + unit_sphere(u_a, u_b) * lrow[4];
  // first valid face whose cdf exceeds u_face
  for (int f = 0; f < n_face; ++f) {
    const float* fr = lrow + LIGHT_HEAD + LIGHT_FACE_COLS * f;
    if (fr[22] > 0.0f && u_face < fr[21]) {
      float x = (u_a * 2.0f - 1.0f) * fr[18];
      float y = (u_b * 2.0f - 1.0f) * fr[19];
      return ld3(fr) + ld3(fr + 3) * x + ld3(fr + 6) * y;
    }
  }
  return {0.0f, 0.0f, 0.0f};
}

__device__ __forceinline__ float light_pdf(const float* lrow, int n_face, V3 org, V3 dir, float cmin, float cmax) {
  if (lrow[0] == 0.0f) {
    float r = lrow[4];
    float t = sphere_t(org, dir, cmin, cmax, ld3(lrow + 1), r);
    return t < INF ? t * t / (PI_F * r * r) : 0.0f;
  }
  float t_b = INF, q_b = 1.0f, area_b = 1.0f;
  for (int f = 0; f < n_face; ++f) {
    const float* fr = lrow + LIGHT_HEAD + LIGHT_FACE_COLS * f;
    if (!(fr[22] > 0.0f)) continue;
    V3 zb = ld3(fr + 15);
    float p;
    // containment bases are the inverse-transposed ones (ux, uy)
    float t = rect_t(org, dir, cmin, cmax, ld3(fr), ld3(fr + 9), ld3(fr + 12), zb, fr[18], fr[19], p);
    if (t < t_b) {
      t_b = t;
      q_b = dot(dir, zb);
      area_b = fr[20];
    }
  }
  return t_b < INF ? t_b * t_b / (area_b * fabsf(q_b)) : 0.0f;
}

// ---- geodesics (bendy_tpu_torch/geodesic.py) ----------------------------

// _acc_frozen: sum over masses of -1.5·rs·h²·rel/|rel|⁵, h² frozen per step
__device__ __forceinline__ V3 acc_frozen(const float* masses, int n_mass,
                                         const float (&h2s)[MAX_MASSES], V3 x) {
  V3 a = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < MAX_MASSES; ++k) {
    if (k < n_mass) {
      const float* m = masses + MASS_COLS * k;
      V3 rel = x - ld3(m);
      float r2 = dot(rel, rel);
      float inv_r = r2 > 0.0f ? 1.0f / sqrtf(fmaxf(r2, (float)1e-20)) : 0.0f;
      float inv_r5 = inv_r * inv_r * inv_r * inv_r * inv_r;
      a = a + rel * (((-1.5f * m[3]) * h2s[k]) * inv_r5);
    }
  }
  return a;
}

// _rk4 with the frozen acceleration: one step of dx = d, dd = a(x)
__device__ __forceinline__ void rk4_step(const float* masses, int n_mass,
                                         const float (&h2s)[MAX_MASSES], V3 x, V3 d, float ds,
                                         V3& x_new, V3& d_new) {
  const float half = ds * 0.5f;
  const V3 k1x = d, k1d = acc_frozen(masses, n_mass, h2s, x);
  const V3 k2x = d + k1d * half;
  const V3 k2d = acc_frozen(masses, n_mass, h2s, x + k1x * half);
  const V3 k3x = d + k2d * half;
  const V3 k3d = acc_frozen(masses, n_mass, h2s, x + k2x * half);
  const V3 k4x = d + k3d * ds;
  const V3 k4d = acc_frozen(masses, n_mass, h2s, x + k3x * ds);
  const float sixth = ds * (float)(1.0 / 6.0);
  x_new = x + (k1x + (k2x + k3x) * 2.0f + k4x) * sixth;
  d_new = d + (k1d + (k2d + k3d) * 2.0f + k4d) * sixth;
}

// _acc_looped: h² recomputed from the stage state, summed in row order
__device__ __forceinline__ V3 acc_looped(const float* masses, int n_mass, V3 x, V3 d) {
  const float d2 = dot(d, d);
  V3 a = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int k = 0; k < n_mass; ++k) {
    const float* m = masses + MASS_COLS * k;
    const V3 rel = x - ld3(m);
    const float r2 = dot(rel, rel);
    const float rd = dot(rel, d);
    // max(h2, 0) that keeps a NaN, as torch.clamp_min and jnp.maximum do
    // (fmaxf would drop it): a stage point thrown past f32's range gives
    // r2 = inf and h2 = inf - inf, and the lane must then go NaN as in the
    // plain version, not on with a finite acceleration
    const float h2_raw = r2 * d2 - rd * rd;
    const float h2 = h2_raw < 0.0f ? 0.0f : h2_raw;
    const float inv_r = r2 > 0.0f ? 1.0f / sqrtf(fmaxf(r2, (float)1e-20)) : 0.0f;
    const float inv_r5 = inv_r * inv_r * inv_r * inv_r * inv_r;
    a = a + rel * ((-1.5f * m[3]) * (h2 * inv_r5));
  }
  return a;
}

// rk4_step_looped: _rk4 with the looped acceleration
__device__ __forceinline__ void rk4_step_looped(const float* masses, int n_mass, V3 x, V3 d,
                                                float ds, V3& x_new, V3& d_new) {
  const float half = ds * 0.5f;
  const V3 k1x = d, k1d = acc_looped(masses, n_mass, x, d);
  const V3 k2x = d + k1d * half;
  const V3 k2d = acc_looped(masses, n_mass, x + k1x * half, k2x);
  const V3 k3x = d + k2d * half;
  const V3 k3d = acc_looped(masses, n_mass, x + k2x * half, k3x);
  const V3 k4x = d + k3d * ds;
  const V3 k4d = acc_looped(masses, n_mass, x + k3x * ds, k4x);
  const float sixth = ds * (float)(1.0 / 6.0);
  x_new = x + (k1x + (k2x + k3x) * 2.0f + k4x) * sixth;
  d_new = d + (k1d + (k2d + k3d) * 2.0f + k4d) * sixth;
}

// ---- media (bendy_tpu_torch/ops/volume.py) -------------------------------

// _axis: corner pair and lerp weights along one axis of c = clamp(coord)·hi
__device__ __forceinline__ void grid_axis(float coord, float hi, int n, bool nearest, int& i0,
                                          int& i1, float& w0, float& w1) {
  const float c = fminf(fmaxf(coord, 0.0f), 1.0f) * hi;
  if (nearest) {
    i0 = i1 = min(max((int)floorf(c + 0.5f), 0), n - 1);
    w0 = 1.0f;
    w1 = 0.0f;
    return;
  }
  const float c0 = floorf(c);
  const float f = c - c0;
  const int a = (int)c0;
  const int b = min(a + 1, (int)hi);
  const bool same = b == a;
  w0 = same ? (1.0f - f) + f : 1.0f - f;
  w1 = same ? 0.0f : f;
  i0 = min(max(a, 0), n - 1);
  i1 = min(max(b, 0), n - 1);
}

// density_sample: the 8 corners of grid g, lerped over x, then y, then z
__device__ __forceinline__ float density_sample(const Params& P, int g, V3 size, V3 coord) {
  int x0, x1, y0, y1, z0, z1;
  float wx0, wx1, wy0, wy1, wz0, wz1;
  const bool nearest = P.nearest != 0;
  grid_axis(coord.x, size.x, P.W, nearest, x0, x1, wx0, wx1);
  grid_axis(coord.y, size.y, P.H, nearest, y0, y1, wy0, wy1);
  grid_axis(coord.z, size.z, P.D, nearest, z0, z1, wz0, wz1);
  g = min(max(g, 0), P.G - 1);
  const float* gp = P.grid + (size_t)g * P.D * P.H * P.W;
  auto row = [&](int z, int y) {
    const float* r = gp + ((size_t)z * P.H + y) * P.W;
    return __ldg(r + x0) * wx0 + __ldg(r + x1) * wx1;
  };
  auto plane = [&](int z) { return row(z, y0) * wy0 + row(z, y1) * wy1; };
  return plane(z0) * wz0 + plane(z1) * wz1;
}

// normalized, clamped per-sample depth; the +INF of an unclaimed or
// emissive-environment sample clamps to 1, and NaN passes through, as jnp.clip
__device__ __forceinline__ float depth_n(float d, float clip_min, float dep_den) {
  float x = (d - clip_min) / dep_den;
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// ---- phase stubs (bendy_tpu_torch/tools/phase_probe.py) -------------------
//
// The phase probe times the loop with one phase at a time replaced by a cheap
// stand-in: the reference's tools/phase_probe.py::_stubs, whose plain
// counterparts are bendy_tpu_torch/tools/phase_probe.py::stubs, the same
// arithmetic. A build with -DBENDY_PHASE_STUBS (_build.py, stubs=True) gives
// trace_kernel one more template parameter, STUB, a mask of the STUB_*
// phases below, and compiles only what the probe runs (the surface, BVH and
// volume item instantiations, FULL output, table in shared memory; the
// masks of STUB_MASKS). Each stand-in derives from a live lane value, so that
// nvcc drops the phase and nothing downstream of it (a constant would let it
// fold the consumers too). Each sits in an `if constexpr` block with
// production in its `else`: STUB_CASE before a production statement, or an
// #ifdef pair where the production code declares what later code reads. A
// stub that leaves a pure computation unread (the density lookup under the
// volume stub) lets nvcc drop it. The default build has neither the blocks
// nor the `else`: it compiles the tokens it compiled before the probe
// existed, so ptxas prints the same lines for it.
#ifdef BENDY_PHASE_STUBS
constexpr int STUB_LIGHT = 1, STUB_SHADE = 2, STUB_SWEEP = 4, STUB_RNG = 8, STUB_CAMERA = 16,
              STUB_VOLUME = 32;
#define STUB_CASE(phase, ...) if constexpr ((STUB & (phase)) != 0) { __VA_ARGS__ } else
#define STUB_PARAM , int STUB = 0

// stub_uniforms: slot i of lane_uniforms is ((sid >> i) & 1)·0.25 + 0.27
// (slots 4·block to 4·block + 3 here), a few operations where pcg4d takes ~40
__device__ __forceinline__ void stub_uniforms4(uint32_t sid, uint32_t block, float u[4]) {
#pragma unroll
  for (uint32_t j = 0; j < 4; ++j)
    u[j] = (float)((sid >> (4u * block + j)) & 1u) * 0.25f + (float)0.27;
}

// stub_hit: t = 1 at org + dir, a hit where dir.x > 0 (a mixed mask) and a
// miss elsewhere, normal -dir, a diffuse surface of albedo 0.6 that also
// emits 0.1 (added where it is shaded: the merged color cannot hold both)
template <bool VOL>
__device__ __forceinline__ HitT<VOL> stub_hit(V3 org, V3 dir) {
  const float zf = org.x * 0.0f;
  HitT<VOL> h;
  h.t = zf + 1.0f;
  h.face = dir.x > 0.0f ? FACE_FRONT : -1;
  h.mtype = MAT_DIFFUSE;
  h.position = org + dir;
  h.normal = -dir;
  h.color = {zf + 0.6f, zf + 0.6f, zf + 0.6f};
  h.rough = zf;
  h.ior = zf + 1.4f;
  if constexpr (VOL) {
    h.vgrid = -1;
    h.srow = -1;
    h.vsize = {zf + 1.0f, zf + 1.0f, zf + 1.0f};
    h.center = org;
    h.radius = zf + 1.0f;
  }
  return h;
}
#else
#define STUB_CASE(phase, ...)
#define STUB_PARAM
#endif

// LOOPM's item pool: the items a launch has handed out past each thread's
// first (item = thread index). A thread draws from it until it gets an index
// past the launch's items, so every thread draws exactly once past them and
// a launch of `items` items draws `items` indices in all (the threads past
// the items, a ragged last block, draw none). The draw of the last one sets
// the counter back to 0 for the next launch: no launch or host call between.
// So LOOPM launches on one device must not overlap: they share the counter.
__device__ unsigned int pool_next;

// The next item of a LOOPM launch of `threads` threads and `items` items (an
// index >= items: the pool is empty). The lanes of a warp that draw together
// take consecutive indices, one atomicAdd a warp.
__device__ __forceinline__ unsigned pool_take(unsigned threads, unsigned items) {
  const unsigned voters = __activemask();
  const int lead = __ffs(voters) - 1, me = threadIdx.x & 31;
  unsigned base = 0;
  if (me == lead) base = atomicAdd(&pool_next, (unsigned)__popc(voters));
  const unsigned k = __shfl_sync(voters, base, lead) + __popc(voters & ((1u << me) - 1u));
  if (k == items - 1) atomicExch(&pool_next, 0u);  // the launch's last draw
  return threads + k;
}

// LOOPM: the loop iterations of the calling thread's finished items, for the
// warp-use count (count_warp_use; in shared memory: a register more moved
// other instantiations' code)
__device__ __forceinline__ int& pool_trips() {
  __shared__ int trips[BLOCK];
  return trips[threadIdx.x];
}

// The lane pool: the surface instantiation in FULL output with its table
// staged whose resident threads take the next lane when theirs ends. It
// takes the LOOPM slot of the template, which no surface instantiation used
// (LOOPM needs GEO), so every other instantiation keeps its name and code.
template <bool GEO, bool LOOPM>
constexpr bool LANE_POOL = LOOPM && !GEO;

// the lanes a warp claims with one draw from the lane pool: a lane a thread
// (64 left up to two lanes a thread in a warp's hands when the pool emptied,
// and the launch waited on them)
constexpr unsigned LANE_RUN = 32;

// The lane pool's draws: the lanes a launch has handed out past each
// thread's first (lane = thread index), LANE_RUN at a time, counted in the
// launch's own word (Params::lane_next, zeroed on the launch's stream by
// launch<>), so two launches never share a counter, on one stream or two.
// The draw whose run reaches the launch's lanes is the pool's last run, and
// its warp draws no more; every other warp draws until it draws past the
// lanes, once: fewer draws than lanes / 32. LOOPM's pool_next is another.

#ifdef BENDY_SWEEP_STATS
// the measuring build: the lane pool's draws and each thread's loop trips
// of the last launch (bendy_lane_pool_stats)
constexpr int LANE_POOL_STATS_THREADS = 1 << 19;
__device__ unsigned long long lane_pool_draws;
__device__ int lane_pool_trips[LANE_POOL_STATS_THREADS];
#endif

// a warp's run of drawn lanes, kept by the warp's thread 0 alone: the next
// lane, the lanes left, and 1 once the warp may draw no more
__device__ __forceinline__ unsigned* lane_run() {
  __shared__ unsigned runs[BLOCK / 32][3];
  return runs[threadIdx.x >> 5];
}

// The next lanes of the warp's threads in `need` (all 32 threads call it,
// `need` the same in each), a launch of `threads` threads over `lanes`
// lanes drawing from its counter `drawn_runs`: the thread of rank r among
// them gets the run's next lanes in rank order, drawing a new run where the
// run holds too few; -1 where the pool is empty.
__device__ __forceinline__ int lane_take(unsigned need, unsigned threads, unsigned lanes,
                                         unsigned* drawn_runs) {
  const unsigned me = threadIdx.x & 31, v = __popc(need);
  unsigned next = 0, left = 0, drawn = ~0u, avail = 0;
  if (me == 0) {
    unsigned* run = lane_run();
    next = run[0];
    left = run[1];
    if (v <= left) {
      run[0] = next + v;
      run[1] = left - v;
    } else {
      run[1] = 0;  // the ranks below `left` take what is left
      if (run[2] == 0u) {
        const unsigned c = atomicAdd(drawn_runs, LANE_RUN);
#ifdef BENDY_SWEEP_STATS
        atomicAdd(&lane_pool_draws, 1ull);
#endif
        drawn = threads + c;
        if (drawn < lanes) {
          avail = min(LANE_RUN, lanes - drawn);
          const unsigned rest = min(v - left, avail);
          run[0] = drawn + rest;
          run[1] = avail - rest;
          run[2] = drawn + LANE_RUN >= lanes ? 1u : 0u;  // the pool's last run
        } else {
          drawn = ~0u;  // the pool is empty
          run[2] = 1u;
        }
      }
    }
  }
  next = __shfl_sync(0xffffffffu, next, 0);
  left = __shfl_sync(0xffffffffu, left, 0);
  drawn = __shfl_sync(0xffffffffu, drawn, 0);
  avail = __shfl_sync(0xffffffffu, avail, 0);
  const unsigned r = __popc(need & ((1u << me) - 1u));
  if (r < left) return (int)(next + r);
  return drawn != ~0u && r - left < avail ? (int)(drawn + (r - left)) : -1;
}

// The end of a LOOPM thread's item: its last completed path folded in (a
// path cut at the cap is not, as the lane loop leaves it) and its words
// written at `item` of the [n_out, N] sums and the [N] counts (depth_n
// applied), as the other instantiations write theirs after their loop (their
// stores stay inline there: in this helper they moved those instantiations'
// opcodes)
template <bool AOVS, bool VOL>
__device__ __forceinline__ void store_item(const Params& P, int N, int item, bool alive,
                                           bool path_open, V3 rad, V3 aov_alb, V3 aov_nrm,
                                           float aov_dep, V3 acc_rad, V3 acc_alb, V3 acc_nrm,
                                           float acc_dep, int rays, int it, int vev, int n_near) {
  if (!alive && path_open) {
    acc_rad = acc_rad + rad;
    if (AOVS) {
      acc_alb = acc_alb + aov_alb;
      acc_nrm = acc_nrm + aov_nrm;
      acc_dep = acc_dep + depth_n(aov_dep, P.clip_min, P.dep_den);
    }
  }
  P.out[item] = acc_rad.x;
  P.out[N + item] = acc_rad.y;
  P.out[2 * N + item] = acc_rad.z;
  if (AOVS) {
    P.out[3 * N + item] = acc_alb.x;
    P.out[4 * N + item] = acc_alb.y;
    P.out[5 * N + item] = acc_alb.z;
    P.out[6 * N + item] = acc_nrm.x;
    P.out[7 * N + item] = acc_nrm.y;
    P.out[8 * N + item] = acc_nrm.z;
    P.out[9 * N + item] = acc_dep;
  }
  P.rays[item] = rays;
  P.iters[item] = it;
  if constexpr (VOL) P.vevents[item] = vev;
  if (P.near_steps != nullptr) P.near_steps[item] = n_near;
}

// The tracer's warp use, the one count of it (telemetry.counters,
// loop_warp_use): with loop_use (profiled passes) each warp of 32 consecutive
// threads adds its threads' loop iterations, `trips`, and 32 × its longest
// thread's to loop_use [2], one atomicAdd pair a warp. A launch of `items`
// lanes or items leaves a trailing partial warp out of both sums
// (ops/trace_kernel.warp_use counts alike): its threads past the items
// returned before the loop, so no full-mask reduction may name them. Every
// instantiation calls it at its end.
__device__ __forceinline__ void count_warp_use(unsigned long long* loop_use, int items,
                                               int trips) {
  if (loop_use == nullptr || ((blockIdx.x * blockDim.x + threadIdx.x) | 31) >= items) return;
  const unsigned sum = __reduce_add_sync(0xffffffffu, (unsigned)trips);
  const unsigned most = __reduce_max_sync(0xffffffffu, (unsigned)trips);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(loop_use, (unsigned long long)sum);
    atomicAdd(loop_use + 1, 32ull * most);
  }
}

// the routing (ops/trace_kernel.per_item): geodesics (LOOPM among them)
// and media without the BVH trace one thread per (lane, sample) item; the
// surface and BVH instantiations one thread per lane
template <bool GEO, bool VOL, bool BVH>
constexpr bool PER_ITEM = GEO || (VOL && !BVH);

// the register budget of the item instantiations (PER_ITEM without LOOPM):
// blocks of BLOCK threads that an SM must hold at once, so that ptxas caps
// the registers to fit: 768 threads an SM (80 registers), 640 with both
// geodesics and media (96); at 128 threads a block 6 and 5 blocks. Where
// BLOCK does not divide the count the blocks round down (256: 3 and 2, that
// is 768 and 512 threads; 512: 1 and 1), so a budget is never tighter than
// the 128-thread build's. The surface instantiation of the main paths
// (no geodesics, SWEEP_ROWS, FULL output) holds 1,024 threads an SM: 8
// blocks of 128, 64 registers (ptxas spills 16 B), which ran cornell and
// cornell2 2 % faster than its own 72 registers (7 blocks) and scene.json
// within its spread; its AOV and GTAB siblings would spill 60-226 B under it
// (PERF.md §6); the lane pool (LANE_POOL) has its budget. Every other
// instantiation, LOOPM's with its rows among them, gets 0 and keeps
// __launch_bounds__(BLOCK) alone: a minimum of 0 blocks emits none (a
// minimum of 1 moves their registers).
template <bool AOVS, bool GEO, bool VOL, bool LOOPM, bool GTAB, bool BVH>
constexpr int MIN_BLOCKS =
    !LOOPM && PER_ITEM<GEO, VOL, BVH>              ? (GEO && VOL ? 640 : 768) / BLOCK
    : !AOVS && !GEO && SWEEP_ROWS<VOL, GTAB, BVH> ? 1024 / BLOCK
                                                  : 0;

// The tracer: one thread per lane, or with PER_ITEM one per (lane, sample)
// item.
template <bool AOVS, bool GEO, bool VOL, bool LOOPM, bool GTAB, bool BVH STUB_PARAM>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS<AOVS, GEO, VOL, LOOPM, GTAB, BVH>)
    trace_kernel(Params P) {
  constexpr bool SPLIT = PER_ITEM<GEO, VOL, BVH>;
  extern __shared__ __align__(16) float smem_tab[];  // float4 node loads (BVH)
  const float* tab = smem_tab;
  if constexpr (GTAB) {
    tab = P.table;  // past shared memory: read in place
  } else if constexpr (SWEEP_ROWS<VOL, GTAB, BVH>) {
    // the sweep rows, then the table
    const int rows = sweep_rows_floats(P.n_sph, P.n_rct, P.n_box);
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
      smem_tab[i] = sweep_row_word(P.table, P.n_sph, P.n_rct, i);
    for (int i = threadIdx.x; i < P.table_floats; i += blockDim.x) smem_tab[rows + i] = P.table[i];
    __syncthreads();
    tab = smem_tab + rows;
  } else {
    for (int i = threadIdx.x; i < P.table_floats; i += blockDim.x) smem_tab[i] = P.table[i];
    __syncthreads();
  }
  // BVH: the node block inside the table (staged with it, or in place with
  // GTAB), each thread's walk stack after the staged table, and the
  // per-thread counts of node and primitive tests
  BvhState<BVH> walk;
  if constexpr (BVH) {
    walk.bvh = tab + P.bvh0;
    walk.stack =
        reinterpret_cast<uint16_t*>(smem_tab + (GTAB ? 0 : P.table_floats)) + threadIdx.x;
  }
  // one thread per lane, or with SPLIT one per (lane, sample): item =
  // lane·spp + s traces the single sample sample0 + s (the other
  // instantiations read P.spp, P.sample0 and P.n as before, so that they
  // compile as before); LOOPM's threads go on with items from the pool
  int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= (SPLIT ? P.n * P.spp : P.n)) return;  // ragged last block
  const int lane = SPLIT ? item / P.spp : item;

  const float* lights = tab + P.n_sph * SPH_COLS + P.n_rct * RCT_COLS + P.n_box * BOX_COLS;
  const int lstride = LIGHT_HEAD + LIGHT_FACE_COLS * P.n_face;
  const float* env = lights + P.n_light * lstride;
  const float* masses = env + ENV_FLOATS;
  const int env_m = (int)env[0];
  const bool env_const = env_m == MAT_FLAT || env_m == MAT_EMISSIVE;
  const V3 env_color = env_const ? ld3(env + 4) : ld3(env + 1);

  // camera (pack_camera_host layout)
  const float* cam = P.cam;
  const float focal = cam[1], aspect = cam[2], fstop = cam[3], focus = cam[4], yfov = cam[5];
  const float* R = cam + 6;
  const V3 cam_t = ld3(cam + 15);
  const bool dof = (P.flags & FLAG_DOF) && focus > 0.0f;

  uint32_t pixv = (uint32_t)P.pix[lane], subv = (uint32_t)P.sub[lane];
  const int n = P.subsample > 1 ? P.subsample : 1;
  const uint32_t nn = (uint32_t)(n * n);
  const float px = (float)(pixv % (uint32_t)P.width), py = (float)(pixv / (uint32_t)P.width);
  const float si = (float)(subv % (uint32_t)n), sj = (float)(subv / (uint32_t)n);
  float u_base = px * P.pw - 1.0f + (si / (float)n) * P.pw;
  float v_base = py * P.ph - 1.0f + (sj / (float)n) * P.ph;

  int sample = -1, path_step = 0, bounce = 0, rays = 0, it = 0;
  bool alive = false, path_open = false, aov_open = false;
  uint32_t sid = 0;
  V3 org = {0.0f, 0.0f, 0.0f}, dir = {0.0f, 0.0f, -1.0f};
  V3 thr = {0.0f, 0.0f, 0.0f}, rad = {0.0f, 0.0f, 0.0f}, acc_rad = {0.0f, 0.0f, 0.0f};
  V3 aov_alb = {0.0f, 0.0f, 0.0f}, aov_nrm = {0.0f, 0.0f, 0.0f};
  V3 acc_alb = {0.0f, 0.0f, 0.0f}, acc_nrm = {0.0f, 0.0f, 0.0f};
  float aov_dep = INF, acc_dep = 0.0f;
  int geo_steps = 0;  // chord steps of the current path
  bool fresh = true;  // first segment after a bounce: clip_min applies
  bool march = false;  // volume instantiation: the lane is marching a medium
  int vbounce = 0, last_sph = -1, vev = 0;
  int n_near = 0;  // RK4 steps taken (near segments), for the work count

  if constexpr (LOOPM) pool_trips() = 0;
  if constexpr (LANE_POOL<GEO, LOOPM>) {
    if ((threadIdx.x & 31) == 0) {
      unsigned* run = lane_run();
      run[0] = run[1] = run[2] = 0u;
    }
  }
  for (; LOOPM || it < P.max_iters; ++it) {
    if constexpr (LANE_POOL<GEO, LOOPM>) {
      // === the lane is done or cut at the cap: its words, the warp's next =
      // (every thread of the warp stays in the loop until all are done, so
      // the warp draws with all 32; launch<> pools only launches with more
      // lanes than threads, so every thread starts on a lane)
      const bool ends = item >= 0 && (it >= P.max_iters || (!alive && sample + 1 >= P.spp));
      const unsigned need = __ballot_sync(0xffffffffu, ends);
      if (need != 0u) {
        if (ends) {
          store_item<AOVS, VOL>(P, P.n, item, alive, path_open, rad, aov_alb, aov_nrm, aov_dep,
                                acc_rad, acc_alb, acc_nrm, acc_dep, rays, it, vev, n_near);
          pool_trips() += it;
        }
        const int next = lane_take(need, gridDim.x * blockDim.x, (unsigned)P.n, P.lane_next);
        if (ends) {
          item = next;
          if (next >= 0) {
            pixv = (uint32_t)P.pix[next];
            subv = (uint32_t)P.sub[next];
            const float pxi = (float)(pixv % (uint32_t)P.width);
            const float pyi = (float)(pixv / (uint32_t)P.width);
            const float sii = (float)(subv % (uint32_t)n), sji = (float)(subv / (uint32_t)n);
            u_base = pxi * P.pw - 1.0f + (sii / (float)n) * P.pw;
            v_base = pyi * P.ph - 1.0f + (sji / (float)n) * P.ph;
            sample = -1;
            it = rays = 0;
            alive = path_open = false;
            acc_rad = {0.0f, 0.0f, 0.0f};
          }
        }
        if (__all_sync(0xffffffffu, item < 0)) break;  // the warp's lanes are all done
      }
      if (item < 0) continue;  // the pool is empty: the thread waits on its warp
    } else if constexpr (LOOPM) {
      // === the item is done or cut at the cap: its words, the pool's next =
      if (it >= P.max_iters || (!alive && sample >= 0)) {
        const int N = P.n * P.spp;
        store_item<AOVS, VOL>(P, N, item, alive, path_open, rad, aov_alb, aov_nrm, aov_dep,
                              acc_rad, acc_alb, acc_nrm, acc_dep, rays, it, vev, n_near);
        pool_trips() += it;
        const unsigned next = pool_take(gridDim.x * blockDim.x, (unsigned)N);
        if (next >= (unsigned)N) break;  // the pool is empty: this thread is done
        item = (int)next;
        pixv = (uint32_t)P.pix[item / P.spp];
        subv = (uint32_t)P.sub[item / P.spp];
        const float pxi = (float)(pixv % (uint32_t)P.width);
        const float pyi = (float)(pixv / (uint32_t)P.width);
        const float sii = (float)(subv % (uint32_t)n), sji = (float)(subv / (uint32_t)n);
        u_base = pxi * P.pw - 1.0f + (sii / (float)n) * P.pw;
        v_base = pyi * P.ph - 1.0f + (sji / (float)n) * P.ph;
        sample = -1;
        it = rays = n_near = 0;
        alive = path_open = false;
        acc_rad = acc_alb = acc_nrm = {0.0f, 0.0f, 0.0f};
        acc_dep = 0.0f;
        if constexpr (VOL) {
          vev = 0;
          last_sph = -1;
        }
      }
    }
    if (!alive) {
      if (sample + 1 >= (SPLIT ? 1 : P.spp)) break;  // this thread is done
      // === finalize the dead path, regenerate a camera ray ==============
      if (path_open) {
        acc_rad = acc_rad + rad;
        if (AOVS) {
          acc_alb = acc_alb + aov_alb;
          acc_nrm = acc_nrm + aov_nrm;
          acc_dep = acc_dep + depth_n(aov_dep, P.clip_min, P.dep_den);
        }
      }
      ++sample;
      path_open = true;
      path_step = 0;
      const uint32_t sample0 = SPLIT ? P.sample0 + (uint32_t)(item % P.spp) : P.sample0;
      sid = (pixv * P.spp_total + (sample0 + (uint32_t)sample)) * nn + subv;
#ifdef BENDY_PHASE_STUBS
      if constexpr ((STUB & STUB_CAMERA) != 0) {
        // stub_camera: one ray from (0, 0, 14) down -z, live through sid,
        // in place of the ray generation and its camera draws
        const float zf = (float)(int32_t)sid * 0.0f;
        org = {zf, zf, zf + 14.0f};
        dir = {zf, zf, zf - 1.0f};
      } else {
#endif
      float uj[4];
      uniforms4(sid, CAMERA_TAG, 0u, P.key0, P.key1, uj);
      float u = u_base + (uj[0] - 0.5f) * P.pw_n;
      float v = v_base + (uj[1] - 0.5f) * P.ph_n;
      float xfov = yfov * aspect;
      float yrot = xfov * 0.5f * -u;
      float xrot = yfov * 0.5f * -v;
      float sin_x, cos_x, sin_y, cos_y;
      if (P.flags & FLAG_POLY) {
        sin_cos_small(xrot, sin_x, cos_x);
        sin_cos_small(yrot, sin_y, cos_y);
      } else {
        sin_x = sinf(xrot);
        cos_x = cosf(xrot);
        sin_y = sinf(yrot);
        cos_y = cosf(yrot);
      }
      V3 d_fr = {-cos_x * sin_y, sin_x, -cos_x * cos_y};
      V3 d_world = normalize(V3{R[0] * d_fr.x + R[1] * d_fr.y + R[2] * d_fr.z,
                                R[3] * d_fr.x + R[4] * d_fr.y + R[5] * d_fr.z,
                                R[6] * d_fr.x + R[7] * d_fr.y + R[8] * d_fr.z});
      org = cam_t;
      dir = d_world;
      if (dof) {
        // thin lens: unit disk about -Z is (cos, -sin, 0)·r
        float s1, c1;
        sin_cos_tau(uj[2], s1, c1);
        float aperture = 0.5f * focal / fstop;
        float dx = (c1 * uj[3]) * aperture;
        float dy = (-s1 * uj[3]) * aperture;
        V3 off = {R[0] * dx + R[1] * dy, R[3] * dx + R[4] * dy, R[6] * dx + R[7] * dy};
        float frac = focus / fabsf(d_fr.z);
        org = cam_t + off;
        dir = normalize(d_world * frac - off);
      }
#ifdef BENDY_PHASE_STUBS
      }
#endif
      thr = {1.0f, 1.0f, 1.0f};
      rad = {0.0f, 0.0f, 0.0f};
      bounce = 0;
      alive = true;
      if constexpr (VOL) {
        march = false;
        vbounce = 0;
      }
      if (AOVS) {
        aov_open = true;
        aov_alb = {0.0f, 0.0f, 0.0f};
        aov_nrm = {0.0f, 0.0f, 0.0f};
        aov_dep = INF;
      }
      if (GEO) {
        geo_steps = 0;
        fresh = true;
      }
    }
    // === bounce-cap kill at path entry (tracer/mod.rs:323-325) ===========
    if constexpr (VOL) {
      // bounces cap surface lanes; a march longer than max_volume_bounces
      // steps dies at entry too (tracer/mod.rs:352-354)
      if (march ? vbounce > P.max_volume_bounces : bounce > P.max_bounces) {
        alive = false;
        ++path_step;
        continue;
      }
    } else if (bounce > P.max_bounces) {
      alive = false;
      ++path_step;
      continue;
    }
    // === propagation segment: the RK4 chord, or a straight ray ==========
    V3 tdir = dir;  // the segment's direction: the chord's, near a mass
    float cmin = P.clip_min, cmax = P.clip_max;
    bool is_near = false;  // a surface lane not yet in flat space
    V3 x_next, d_next;
    if constexpr (GEO) {
      // geo_step_begin: capture, far field, step size and frozen h² in one
      // sweep over the masses (geodesic.py:145)
      bool captured = false, far_field = true;
      float r2_min = INF;
      const float d2 = dot(dir, dir);
      float h2s[MAX_MASSES];
      if constexpr (LOOPM) {
        // geo_step_begin_looped: the same compares over any count, no h²
        for (int k = 0; k < P.n_mass; ++k) {
          const float* m = masses + MASS_COLS * k;
          const float rs = m[3];
          const V3 rel = org - ld3(m);
          const float r2 = dot(rel, rel);
          const float rd = dot(rel, dir);
          const float far_r = P.far * rs;
          captured = captured || r2 < rs * rs;
          far_field = far_field && r2 > far_r * far_r && rd > 0.0f;
          r2_min = fminf(r2_min, r2);
        }
      } else {
#pragma unroll
        for (int k = 0; k < MAX_MASSES; ++k) {
          h2s[k] = 0.0f;
          if (k < P.n_mass) {
            const float* m = masses + MASS_COLS * k;
            const float rs = m[3];
            const V3 rel = org - ld3(m);
            const float r2 = dot(rel, rel);
            const float rd = dot(rel, dir);
            const float far_r = P.far * rs;
            captured = captured || r2 < rs * rs;
            far_field = far_field && r2 > far_r * far_r && rd > 0.0f;
            r2_min = fminf(r2_min, r2);
            h2s[k] = fmaxf(r2 * d2 - rd * rd, 0.0f);
          }
        }
      }
      // horizon capture, or the step budget spent: the path is swallowed
      if constexpr (VOL) {
        // capture applies to marching lanes too, the budget does not
        if (captured || (!march && geo_steps > P.max_steps)) {
          alive = false;
          ++path_step;
          continue;
        }
      } else if (captured || geo_steps > P.max_steps) {
        alive = false;
        ++path_step;
        continue;
      }
      is_near = !far_field;
      if constexpr (VOL) is_near = is_near && !march;  // a march steps straight
      if (is_near) {
        const float eta = P.eta * (1.0f + P.growth * (float)geo_steps);
        const float ds = fminf(fmaxf(eta * sqrtf(r2_min), P.min_step), P.max_step);
        if constexpr (LOOPM) {
          rk4_step_looped(masses, P.n_mass, org, dir, ds, x_next, d_next);
        } else {
          rk4_step(masses, P.n_mass, h2s, org, dir, ds, x_next, d_next);
        }
        const V3 chord = x_next - org;
        const float chord_len = sqrtf(dot(chord, chord));
        tdir = chord * (1.0f / fmaxf(chord_len, (float)1e-20));
        cmax = chord_len;
      }
      cmin = fresh ? P.clip_min : 0.0f;
    }
    if constexpr (VOL) {
      if (march) {  // the march clip (tracer/mod.rs:382-387)
        cmin = 0.0f;
        cmax = P.volume_step;
      }
    }
    ++rays;
#ifdef BENDY_PHASE_STUBS
    HitT<VOL> h;
    if constexpr ((STUB & STUB_SWEEP) != 0) {
      h = stub_hit<VOL>(org, tdir);  // the sweep, or the BVH walk
    } else {
      h = nearest_hit<VOL, BVH, SWEEP_ROWS<VOL, GTAB, BVH>>(
          tab, P.n_sph, P.n_rct, P.n_box, cmin, cmax, org, tdir, march, last_sph, walk);
    }
#else
    HitT<VOL> h = nearest_hit<VOL, BVH, SWEEP_ROWS<VOL, GTAB, BVH>>(
        tab, P.n_sph, P.n_rct, P.n_box, cmin, cmax, org, tdir, march, last_sph, walk);
#endif
    if (GEO && is_near) ++geo_steps;
    if constexpr (SPLIT) n_near += is_near;
    if (GEO && is_near && h.face < 0) {
      // no hit inside the chord: keep bending from its end point
      org = x_next;
      dir = d_next;
      fresh = false;
      ++path_step;
      continue;
    }
    if (h.face < 0) {
      // === miss: environment (tracer/mod.rs:429-452) =====================
      rad = rad + thr * env_color;
      if (AOVS && aov_open) {
        aov_alb = env_const ? V3{0.0f, 0.0f, 0.0f} : env_color;
        aov_nrm = env_m == MAT_EMISSIVE ? V3{0.0f, 0.0f, 0.0f} : -dir;
        aov_dep = env_m == MAT_EMISSIVE ? INF : P.clip_max;
        aov_open = false;
      }
      alive = false;
      ++path_step;
      continue;
    }
    if constexpr (VOL) {
      if (h.face >= 2) {
        // === volume event: march step or volume face (ops/volume.py) =====
        // (a volume face or the interior event is always a sphere with a grid)
        ++vev;
        float u[4];
        STUB_CASE(STUB_RNG, stub_uniforms4(sid, 0u, u);)
        uniforms4(sid, (uint32_t)path_step, 0u, P.key0, P.key1, u);
        const V3 bmin = {h.center.x - h.radius, h.center.y - h.radius, h.center.z - h.radius};
        const float bsize = 2.0f * h.radius;
        const V3 coord = {(h.position.x - bmin.x) / bsize, (h.position.y - bmin.y) / bsize,
                          (h.position.z - bmin.z) / bsize};
        const float density = P.volume_step * density_sample(P, h.vgrid, h.vsize, coord);
        V3 new_org = h.position, new_dir = tdir;
        // stub_volume_shade: a scatter where u2 < 0.3 (a live mixed mask), in
        // place and straight on, weight 0.8; the lookup above goes unread
        STUB_CASE(STUB_VOLUME, if (u[2] < 0.3f) {
          thr = thr * (h.t * 0.0f + 0.8f);
          if (AOVS && aov_open) {
            aov_alb = {SCATTER_ALBEDO, SCATTER_ALBEDO, SCATTER_ALBEDO};
            aov_nrm = h.normal;
            aov_dep = h.t;
            aov_open = false;
          }
        })
        if (u[0] < density) {
          // scatter: isotropic, albedo 0.8; interior events jitter the
          // origin up to one step back (volume.rs:38-53)
          if (h.face == FACE_VOLUME) new_org = h.position - tdir * (P.volume_step * u[1]);
          new_dir = unit_sphere(u[2], u[3]);
          thr = thr * SCATTER_ALBEDO;
          if (AOVS && aov_open) {
            aov_alb = {SCATTER_ALBEDO, SCATTER_ALBEDO, SCATTER_ALBEDO};
            aov_nrm = h.normal;
            aov_dep = h.t;
            aov_open = false;
          }
        }
        if (h.face == FACE_VOLUME_BACK) {  // exit at bounce+1 (tracer/mod.rs:503-513)
          march = false;
          ++bounce;
        } else {
          vbounce = march ? vbounce + 1 : 1;
          march = true;
          last_sph = h.srow;
        }
        if (GEO) fresh = true;  // a volume event restarts the chord clip
        org = new_org;
        dir = new_dir;
        ++path_step;
        continue;
      }
      march = false;  // a surface event: shaded below, then surface mode or dead
    }
    // === shade the surface (ops/materials.py::shade_surface) =============
#ifdef BENDY_PHASE_STUBS
    if constexpr ((STUB & STUB_SHADE) != 0) {
      // stub_shade: emits 0.1, scatters where u1 < 0.5 (a live mixed mask),
      // straight on with weight 0.5
      float u[4];
      STUB_CASE(STUB_RNG, stub_uniforms4(sid, 0u, u);)
      uniforms4(sid, (uint32_t)path_step, 0u, P.key0, P.key1, u);
      const bool scatter = u[1] < 0.5f;
      rad = rad + thr * 0.1f;
      if (AOVS && aov_open) {
        aov_alb = {0.5f, 0.5f, 0.5f};
        aov_nrm = h.normal;
        aov_dep = h.t;
        aov_open = false;
      }
      if (GEO) fresh = true;
      if (scatter) {
        thr = thr * 0.5f;
        org = h.position;
        dir = tdir;
        ++bounce;
      } else {
        alive = false;
      }
      ++path_step;
    } else {
#endif
    float u[4];
    STUB_CASE(STUB_RNG, stub_uniforms4(sid, 0u, u);)
    uniforms4(sid, (uint32_t)path_step, 0u, P.key0, P.key1, u);
    const V3 n = h.normal;
    bool scatter = false;
    V3 weight = h.color, new_dir = tdir;
    if (h.mtype == MAT_DIFFUSE && (P.flags & FLAG_DIFFUSE)) {
      float u45[4];
      STUB_CASE(STUB_RNG, stub_uniforms4(sid, 1u, u45);)
      uniforms4(sid, (uint32_t)path_step, 1u, P.key0, P.key1, u45);
      const int nl = P.n_light;
      float scaled = u[0] * (float)nl;
      int li = (int)scaled;  // truncation toward zero, as astype(int32)
      li = li < 0 ? 0 : (li > nl - 1 ? nl - 1 : li);
      float u_face = scaled - floorf(scaled);
      const float* lrow = lights + li * lstride;
      V3 d_cos = cosine_hemisphere(n, u[2], u[3]);
#ifdef BENDY_PHASE_STUBS
      V3 lp;
      if constexpr ((STUB & STUB_LIGHT) != 0) {
        // stub_light_point: live through u4, one multiply-add a component
        lp = {u45[0] * 0.5f + 1.0f, u45[0] * 0.5f + 2.0f, u45[0] * 0.5f + 0.5f};
      } else {
        lp = sample_light_point(lrow, P.n_face, u45[0], u45[1], u_face);
      }
#else
      V3 lp = sample_light_point(lrow, P.n_face, u45[0], u45[1], u_face);
#endif
      V3 d_light = normalize(lp - h.position);
      V3 d_diff = u[1] < 0.5f ? d_light : d_cos;
      float pdf_cos = dot(n, d_diff) * (float)(1.0 / 3.14159265358979323846);
#ifdef BENDY_PHASE_STUBS
      float pdf_light;
      if constexpr ((STUB & STUB_LIGHT) != 0) {
        pdf_light = h.position.x * 0.0f + d_diff.x * 0.1f + 0.3f;  // stub_light_pdf
      } else {
        pdf_light = light_pdf(lrow, P.n_face, h.position, d_diff, P.clip_min, P.clip_max);
      }
#else
      float pdf_light = light_pdf(lrow, P.n_face, h.position, d_diff, P.clip_min, P.clip_max);
#endif
      float pdf_mix = pdf_cos + (pdf_light - pdf_cos) * 0.5f;
      scatter = !(fabsf(pdf_mix) <= EPS_PAR);  // |shader_pdf| <= 1e-5 absorbs
      weight = h.color * (pdf_cos / (scatter ? pdf_mix : 1.0f));
      new_dir = d_diff;
    } else if (h.mtype == MAT_METALLIC && (P.flags & FLAG_METALLIC)) {
      V3 fuzz = unit_hemisphere(n, u[2], u[3]);
      new_dir = normalize(reflect(tdir, n) + fuzz * h.rough);
      scatter = true;
    } else if (h.mtype == MAT_GLASS && (P.flags & FLAG_GLASS)) {
      V3 fuzz = unit_hemisphere(n, u[2], u[3]);
      float ior_eff = h.face == FACE_FRONT ? 1.0f / h.ior : h.ior;
      float cos_theta = fminf(dot(-tdir, n), 1.0f);
      float sin_theta = sqrtf(fmaxf(1.0f - cos_theta * cos_theta, 0.0f));
      float fr = fresnel(tdir, n, ior_eff);
      bool do_reflect = ior_eff * sin_theta > 1.0f || u[1] < fr;
      V3 base = do_reflect ? reflect(tdir, n) : refract(tdir, n, ior_eff);
      new_dir = normalize(base + fuzz * h.rough);
      scatter = true;
    }
    const bool emitting = h.mtype == MAT_FLAT || h.mtype == MAT_EMISSIVE;
    if (emitting) rad = rad + thr * h.color;
#ifdef BENDY_PHASE_STUBS
    if constexpr ((STUB & STUB_SWEEP) != 0) rad = rad + thr * (h.t * 0.0f + 0.1f);  // stub_hit emits
#endif
    if (AOVS && aov_open) {
      aov_alb = scatter ? h.color : (emitting ? h.color : V3{0.0f, 0.0f, 0.0f});
      aov_nrm = scatter ? n : V3{0.0f, 0.0f, 0.0f};
      aov_dep = scatter ? h.t : INF;
      aov_open = false;
    }
    if (GEO) fresh = true;  // a surface event restarts the chord clip
    if (scatter) {
      thr = thr * weight;
      org = h.position;
      dir = new_dir;
      ++bounce;
    } else {
      alive = false;
    }
    ++path_step;
#ifdef BENDY_PHASE_STUBS
    }
#endif
  }

  if constexpr (LANE_POOL<GEO, LOOPM>) {
    // every lane written in the loop; a thread's loop trips are its lanes'
    // iterations summed
#ifdef BENDY_SWEEP_STATS
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < LANE_POOL_STATS_THREADS) lane_pool_trips[t] = pool_trips();
#endif
    count_warp_use(P.loop_use, P.n, pool_trips());
    return;
  }
  if constexpr (LOOPM) {
    // every item written in the loop; a thread's loop trips are its items'
    // iterations summed
    count_warp_use(P.loop_use, P.n * P.spp, pool_trips());
    return;
  }
  // fold in the lane's last completed path
  if (!alive && path_open) {
    acc_rad = acc_rad + rad;
    if (AOVS) {
      acc_alb = acc_alb + aov_alb;
      acc_nrm = acc_nrm + aov_nrm;
      acc_dep = acc_dep + depth_n(aov_dep, P.clip_min, P.dep_den);
    }
  }
  const int N = SPLIT ? P.n * P.spp : P.n;
  P.out[item] = acc_rad.x;
  P.out[N + item] = acc_rad.y;
  P.out[2 * N + item] = acc_rad.z;
  if (AOVS) {
    P.out[3 * N + item] = acc_alb.x;
    P.out[4 * N + item] = acc_alb.y;
    P.out[5 * N + item] = acc_alb.z;
    P.out[6 * N + item] = acc_nrm.x;
    P.out[7 * N + item] = acc_nrm.y;
    P.out[8 * N + item] = acc_nrm.z;
    P.out[9 * N + item] = acc_dep;
  }
  P.rays[item] = rays;
  P.iters[item] = it;
  if constexpr (VOL) P.vevents[item] = vev;
  if constexpr (SPLIT) {
    if (P.near_steps != nullptr) P.near_steps[item] = n_near;
  }
  if constexpr (BVH) {
    if (P.bvh_tests != nullptr) {
      P.bvh_tests[item] = walk.node_tests;
      P.bvh_tests[N + item] = walk.prim_tests;
    }
  }
  // (LOOPM counted its own above: this dead call, compiled into its
  // instantiations, moved their loops' code)
  if constexpr (!LOOPM) count_warp_use(P.loop_use, N, it);
}

// The ordered fold of a per-item launch: each lane's spp per-item words
// added in sample order, acc = acc + v from 0.0f (or from the running sums
// of the samples before this chunk when !first), the counts as integers,
// into the one-thread-per-lane layouts: out [n_out, n], rays, iters and the
// optional vevents and near_steps [n]. With max_iters >= 0 (the call's last
// chunk) it adds to *over_cap each lane whose iteration sum passes the lane
// cap. Bound by bytes: each word is read once and each lane's words written
// once.
//
// A thread per lane that reads its own words v[s] reads at a stride of spp
// words: a warp's load touches 32 sectors for 4 bytes of each, and only L1
// reuse at small spp hid it (on an H100 80GB HBM3 at 700 W, one fold of
// 64 samples of 262,144 lanes took 0.338 ms, two of 36 + 28 0.087 ms
// each: PERF.md §6). Here a block of FOLD_LANES threads
// folds FOLD_LANES consecutive lanes, whose words in one row are one
// contiguous run (item = lane·spp + s): a stage copies the run of a row's
// tile of up to FOLD_TILE samples into shared memory (cp.async, consecutive
// threads on consecutive words), the next stage's copy in flight while the
// threads add this one's, each its own lane's words in sample order from a
// tile row padded to an odd stride (a warp reading sample s of 32 lanes hits
// 32 banks).
constexpr int FOLD_LANES = 128, FOLD_TILE = 64;

__device__ __forceinline__ void copy_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the fold's tile row stride: the tile's samples, odd
__host__ __device__ __forceinline__ int fold_stride(int spp) {
  return (spp < FOLD_TILE ? spp : FOLD_TILE) | 1;
}

__global__ void __launch_bounds__(FOLD_LANES) fold_kernel(const float* samp, const int32_t* cnt,
                                                          int n, int spp, int n_out, bool first,
                                                          int max_iters, float* out,
                                                          int32_t* rays, int32_t* iters,
                                                          int32_t* vevents, int32_t* near_steps,
                                                          int32_t* over_cap) {
  extern __shared__ uint32_t fold_tiles[];  // [2][FOLD_LANES · stride]
  const int t = threadIdx.x, lane0 = blockIdx.x * FOLD_LANES, lane = lane0 + t;
  const int lanes = min(FOLD_LANES, n - lane0), stride = fold_stride(spp);
  const int tiles = (spp + FOLD_TILE - 1) / FOLD_TILE;
  const size_t items = (size_t)n * spp;
  // the rows: n_out sums, then each count whose output is given
  auto dst = [&](int w) {
    return w == 0 ? rays : w == 1 ? iters : w == 2 ? vevents : near_steps;
  };
  uint32_t rows = (1u << n_out) - 1u;
#pragma unroll
  for (int w = 0; w < N_COUNTS; ++w)
    if (dst(w) != nullptr) rows |= 1u << (n_out + w);
  // stage (row r, tile j) into buffer b: element e = l·ts + i is lane
  // lane0 + l's sample j·FOLD_TILE + i, consecutive e on consecutive words
  // within a lane's run (the whole block's run when one tile holds spp)
  auto stage = [&](int r, int j, int b) {
    const int s0 = j * FOLD_TILE, ts = min(FOLD_TILE, spp - s0);
    const uint32_t* src = (r < n_out ? reinterpret_cast<const uint32_t*>(samp) + (size_t)r * items
                                     : reinterpret_cast<const uint32_t*>(cnt) +
                                           (size_t)(r - n_out) * items) +
                          (size_t)lane0 * spp + s0;
    uint32_t* tile = fold_tiles + b * FOLD_LANES * stride;
    const int dl = FOLD_LANES / ts, di = FOLD_LANES % ts;
    int l = t / ts, i = t % ts;
    for (int e = t; e < lanes * ts; e += FOLD_LANES) {
      copy_async4(tile + l * stride + i, src + (size_t)l * spp + i);
      l += dl;
      i += di;
      if (i >= ts) {
        i -= ts;
        ++l;
      }
    }
    copy_commit();
  };
  int r = 0, j = 0;  // the stage being added: row r (rows' lowest bit), tile j
  stage(r, j, 0);
  float fsum = 0.0f;
  int32_t isum = 0;
  for (int q = 0;; ++q) {
    int nr = r, nj = j + 1;  // the next stage, copied while this one is added
    if (nj == tiles) {
      const uint32_t rest = rows & ~((2u << r) - 1u);
      nr = rest ? __ffs(rest) - 1 : -1;
      nj = 0;
    }
    if (nr >= 0) {
      stage(nr, nj, (q + 1) & 1);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    if (lane < n) {
      const uint32_t* v = fold_tiles + (q & 1) * FOLD_LANES * stride + t * stride;
      const int ts = min(FOLD_TILE, spp - j * FOLD_TILE);
      const bool last = j == tiles - 1;
      if (r < n_out) {
        float acc = j > 0 ? fsum : first ? 0.0f : out[(size_t)r * n + lane];
        for (int i = 0; i < ts; ++i) acc = acc + __uint_as_float(v[i]);
        fsum = acc;
        if (last) out[(size_t)r * n + lane] = acc;
      } else {
        const int w = r - n_out;
        int32_t acc = j > 0 ? isum : first ? 0 : dst(w)[lane];
        for (int i = 0; i < ts; ++i) acc += (int32_t)v[i];
        isum = acc;
        if (last) {
          dst(w)[lane] = acc;
          if (w == 1 && max_iters >= 0 && acc > max_iters) atomicAdd(over_cap, 1);
        }
      }
    }
    __syncthreads();  // buffer q & 1 is free for stage q + 2
    if (nr < 0) break;
    r = nr;
    j = nj;
  }
}

template <bool GEO, bool VOL, bool LOOPM = false, bool BVH = false>
auto instance(bool want_aovs, bool gtab) {
  return gtab ? (want_aovs ? trace_kernel<true, GEO, VOL, LOOPM, true, BVH>
                           : trace_kernel<false, GEO, VOL, LOOPM, true, BVH>)
              : (want_aovs ? trace_kernel<true, GEO, VOL, LOOPM, false, BVH>
                           : trace_kernel<false, GEO, VOL, LOOPM, false, BVH>);
}

// the floats a launch stages unless FLAG_GTAB: its table and, for a
// SWEEP_ROWS instantiation (`rows`), the sweep rows in front of it
size_t staged_floats(const Params& P, bool rows) {
  return (size_t)P.table_floats + (rows ? sweep_rows_floats(P.n_sph, P.n_rct, P.n_box) : 0);
}

// the dynamic shared memory of a launch: what it stages (unless FLAG_GTAB)
// and the BVH's walk stacks
size_t dynamic_smem(const Params& P, bool bvh, bool rows) {
  return ((P.flags & FLAG_GTAB) ? 0 : sizeof(float) * staged_floats(P, rows)) +
         (bvh ? BVH_STACK_BYTES : 0);
}

// the register budget (MIN_BLOCKS) of the instance<GEO, VOL, LOOPM>(aovs, gtab) runs
template <bool GEO, bool VOL, bool LOOPM = false>
int min_blocks(bool aovs, bool gtab) {
  return gtab ? (aovs ? MIN_BLOCKS<true, GEO, VOL, LOOPM, true, false>
                      : MIN_BLOCKS<false, GEO, VOL, LOOPM, true, false>)
              : (aovs ? MIN_BLOCKS<true, GEO, VOL, LOOPM, false, false>
                      : MIN_BLOCKS<false, GEO, VOL, LOOPM, false, false>);
}

// the blocks of `kernel` with `smem` bytes of dynamic shared memory that
// the current device holds at once, into `blocks`
cudaError_t resident_blocks(void (*kernel)(Params), size_t smem, int* blocks) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = per_sm * sms;
  return e;
}

// launch `kernel` over `items` threads with `smem` bytes of dynamic shared
// memory; with `pool` (LOOPM) over no more blocks than the device holds at
// once, whose threads take the rest of the items from the pool
int launch_kernel(void (*kernel)(Params), int items, size_t smem, const Params& P,
                  cudaStream_t s, bool pool = false) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int blocks = (items + BLOCK - 1) / BLOCK;
  if (pool) {
    int resident = 0;
    const cudaError_t e = resident_blocks(kernel, smem, &resident);
    if (e != cudaSuccess) return (int)e;
    if (resident < 1) return (int)cudaErrorLaunchOutOfResources;
    if (blocks > resident) blocks = resident;
  }
  kernel<<<blocks, BLOCK, smem, s>>>(P);
  // a launch refused for registers or shared memory never runs, and a later
  // synchronize() does not report it: the wrapper raises on this code
  return (int)cudaGetLastError();
}

#ifndef BENDY_PHASE_STUBS  // the stub build launches its masks alone (launch_stub)
// The lane pool's rule (ops/trace_kernel.pools_lanes is its mirror): a
// surface launch in FULL output with its table staged runs the lane pool
// where its lanes are at least LANE_POOL_MIN times the threads the device
// holds at once of the pooled instantiation, `resident`, and a lane holds
// at most LANE_POOL_SPP samples; else one thread a lane. Below that many
// lanes the pool's tail (a lane a thread when it empties) costs what it
// saves; past that many samples a lane's paths average out, the static
// warps run nearly full (88 % at 64), and the pool's dearer iteration costs
// more than it recovers (PERF.md §6).
constexpr int LANE_POOL_MIN = 3, LANE_POOL_SPP = 16;
bool pools_lanes(long long lanes, int spp, long long resident) {
  return resident > 0 && lanes >= LANE_POOL_MIN * resident && spp <= LANE_POOL_SPP;
}

// the lane pool's instantiation
constexpr auto lane_pool_kernel = trace_kernel<false, false, false, true, false, false>;

// the resident threads of the lane pool for a launch of `P` (0 where its
// output or table rules it out), into `threads`; the occupancy query (1.7
// us of host time, measured on an H100 machine) is asked once for each
// device and shared memory in turn
cudaError_t lane_pool_threads(const Params& P, bool want_aovs, int* threads) {
  *threads = 0;
  if (want_aovs || (P.flags & (FLAG_GTAB | FLAG_BVH))) return cudaSuccess;
  thread_local int last_dev = -1, last_blocks = 0;
  thread_local size_t last_smem = 0;
  const size_t smem = dynamic_smem(P, false, true);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev != last_dev || smem != last_smem)) {
    e = resident_blocks(lane_pool_kernel, smem, &last_blocks);
    last_dev = e == cudaSuccess ? dev : -1;
    last_smem = smem;
  }
  if (e == cudaSuccess) *threads = last_blocks * BLOCK;
  return e;
}

// launch `P` on `s`; a surface launch that pools (pools_lanes) counts its
// draws in `lane_next`, one device word of its own, zeroed here on `s`
template <bool GEO, bool VOL, bool LOOPM = false, bool BVH = false>
int launch(const Params& P, bool want_aovs, cudaStream_t s, void* lane_next = nullptr) {
  const size_t smem = dynamic_smem(P, BVH, SWEEP_ROWS<VOL, false, BVH>);
  if constexpr (!GEO && !VOL && !BVH) {
    int threads = 0;
    cudaError_t e = lane_pool_threads(P, want_aovs, &threads);
    if (e != cudaSuccess) return (int)e;
    // the resident grid, whose threads take the lanes past their first
    if (pools_lanes(P.n, P.spp, threads)) {
      if (lane_next == nullptr) return (int)cudaErrorInvalidValue;
      e = cudaMemsetAsync(lane_next, 0, sizeof(unsigned), s);
      if (e != cudaSuccess) return (int)e;
      Params Q = P;
      Q.lane_next = static_cast<unsigned*>(lane_next);
      return launch_kernel(lane_pool_kernel, threads, smem, Q, s);
    }
  }
  return launch_kernel(instance<GEO, VOL, LOOPM, BVH>(want_aovs, (P.flags & FLAG_GTAB) != 0),
                       PER_ITEM<GEO, VOL, BVH> ? P.n * P.spp : P.n, smem, P, s, LOOPM);
}
#endif

// the phase stubs' mask rides in a launch's flags above the FLAG_* bits; the
// default build refuses a launch that carries one
constexpr int STUB_SHIFT = 9;

#ifdef BENDY_PHASE_STUBS
// the masks the stub build instantiates: each phase alone, and the floor
// (shade, sweep, rng and camera); the volume one only with media
constexpr int STUB_MASKS[] = {0, STUB_LIGHT, STUB_SHADE, STUB_SWEEP, STUB_RNG, STUB_CAMERA,
                              STUB_SHADE | STUB_SWEEP | STUB_RNG | STUB_CAMERA, STUB_VOLUME};
constexpr int N_STUB_MASKS = sizeof(STUB_MASKS) / sizeof(STUB_MASKS[0]);

// a launch's mask as the build instantiates it: the light stubs sit inside
// the shade (marchspec, shade + light, runs shade's), and a surface
// instantiation has no volume event to stub
int stub_mask(int flags, bool vol) {
  int mask = flags >> STUB_SHIFT;
  if (mask & STUB_SHADE) mask &= ~STUB_LIGHT;
  if (!vol) mask &= ~STUB_VOLUME;
  return mask;
}

// launch the instantiation of `mask` (one of STUB_MASKS, else refused)
template <bool VOL, bool BVH, int I = 0>
int launch_stub(const Params& P, int mask, cudaStream_t s) {
  if constexpr (I == N_STUB_MASKS) {
    return (int)cudaErrorInvalidValue;
  } else if constexpr (!VOL && STUB_MASKS[I] == STUB_VOLUME) {
    return launch_stub<VOL, BVH, I + 1>(P, mask, s);
  } else {
    if (mask != STUB_MASKS[I]) return launch_stub<VOL, BVH, I + 1>(P, mask, s);
    return launch_kernel(trace_kernel<false, false, VOL, false, false, BVH, STUB_MASKS[I]>,
                         PER_ITEM<false, VOL, BVH> ? P.n * P.spp : P.n,
                         dynamic_smem(P, BVH, SWEEP_ROWS<VOL, false, BVH>), P, s);
  }
}
#endif

Params make_params(const void* table, int table_floats, const void* cam, const void* pix,
                   const void* sub, void* out, void* rays, void* iters, int n, int width,
                   int height, int spp, int subsample, unsigned spp_total, unsigned key0,
                   unsigned key1, unsigned sample0, int max_bounces, int max_iters,
                   float clip_min, float clip_max, int flags, int n_sph, int n_rct, int n_box,
                   int n_light, int n_face, int bvh0, void* bvh_tests, void* loop_use) {
  Params P = {};
  P.table = static_cast<const float*>(table);
  P.cam = static_cast<const float*>(cam);
  P.pix = static_cast<const int32_t*>(pix);
  P.sub = static_cast<const int32_t*>(sub);
  P.out = static_cast<float*>(out);
  P.rays = static_cast<int32_t*>(rays);
  P.iters = static_cast<int32_t*>(iters);
  P.n = n;
  P.table_floats = table_floats;
  P.width = width;
  P.height = height;
  P.spp = spp;
  P.subsample = subsample;
  P.spp_total = spp_total;
  P.key0 = key0;
  P.key1 = key1;
  P.sample0 = sample0;
  P.max_bounces = max_bounces;
  P.max_iters = max_iters;
  P.flags = flags;
  P.clip_min = clip_min;
  P.clip_max = clip_max;
  // the reference's Python-double constants, rounded once to f32
  P.dep_den = (float)((double)clip_max - (double)clip_min);
  const int ns = subsample > 1 ? subsample : 1;
  P.pw = (float)(2.0 / width);
  P.ph = (float)(2.0 / height);
  P.pw_n = (float)(2.0 / width / ns);
  P.ph_n = (float)(2.0 / height / ns);
  P.n_sph = n_sph;
  P.n_rct = n_rct;
  P.n_box = n_box;
  P.n_light = n_light;
  P.n_face = n_face;
  P.bvh0 = bvh0;
  P.bvh_tests = static_cast<int32_t*>(bvh_tests);
  P.loop_use = static_cast<unsigned long long*>(loop_use);
  return P;
}

// a BVH launch needs its node block inside the table, at a float4 boundary
bool bvh_args_ok(int flags, int bvh0, int table_floats) {
  return !(flags & FLAG_BVH) ||
         (bvh0 >= 0 && bvh0 % 4 == 0 && (long long)bvh0 + BVH_HEAD <= table_floats);
}

// a per-item launch (PER_ITEM) numbers its n·spp items in int32
bool items_ok(bool per_item, int n, int spp) {
  return !per_item || (long long)n * spp <= INT32_MAX;
}

}  // namespace

#define TRACE_ARGS                                                                               \
  const void *table, int table_floats, const void *cam, const void *pix, const void *sub,         \
      void *out, void *rays, void *iters, int n, int width, int height, int spp, int subsample,   \
      unsigned spp_total, unsigned key0, unsigned key1, unsigned sample0, int max_bounces,       \
      int max_iters, float clip_min, float clip_max, int flags, int n_sph, int n_rct, int n_box, \
      int n_light, int n_face, int want_aovs, int bvh0, void *bvh_tests, void *loop_use
#define TRACE_PARAMS                                                                             \
  make_params(table, table_floats, cam, pix, sub, out, rays, iters, n, width, height, spp,      \
              subsample, spp_total, key0, key1, sample0, max_bounces, max_iters, clip_min,       \
              clip_max, flags, n_sph, n_rct, n_box, n_light, n_face, bvh0, bvh_tests, loop_use)

extern "C" {

// Launch the surface instantiation on `stream`; returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for a geodesic configuration.
// With FLAG_BVH it walks the node block at float `bvh0` of `table`
// (ops/bvh.py) and, when `bvh_tests` is not null, writes each lane's node
// and primitive test counts to it ([2, n] int32); without, both are ignored.
// A non-null `loop_use` [2] int64 gets the launch's warp use added to it
// (count_warp_use: its threads' loop iterations and the iterations its warps
// issued), in every entry and instantiation. `lane_next` is one device word
// (4 bytes) of the caller's: a launch that runs the lane pool (pools_lanes;
// bendy_lane_pool says which) zeroes it on `stream` and counts its draws in
// it, and is refused without it; a launch that does not leaves it alone.
// The stub build launches the instantiation of the stub mask in `flags`
// (FULL output, table in shared memory only) and ignores `lane_next`.
int bendy_trace_surface(TRACE_ARGS, void* lane_next, void* stream) {
  if ((flags & (FLAG_GEO | FLAG_LOOPM)) || !bvh_args_ok(flags, bvh0, table_floats))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
#ifdef BENDY_PHASE_STUBS
  if (want_aovs || (flags & FLAG_GTAB)) return (int)cudaErrorInvalidValue;
  const int mask = stub_mask(flags, false);
  return (flags & FLAG_BVH) ? launch_stub<false, true>(TRACE_PARAMS, mask, s)
                            : launch_stub<false, false>(TRACE_PARAMS, mask, s);
#else
  if (flags >> STUB_SHIFT) return (int)cudaErrorInvalidValue;
  if (flags & FLAG_BVH) return launch<false, false, false, true>(TRACE_PARAMS, want_aovs != 0, s);
  return launch<false, false>(TRACE_PARAMS, want_aovs != 0, s, lane_next);
#endif
}

// Launch the geodesic instantiation (1 <= n_mass <= 8 unrolled masses, or
// with FLAG_LOOPM the LOOPM one over any n_mass >= 1; the mass block after
// the environment in `table`) on `stream`. It runs one thread per (lane,
// sample) (the LOOPM or the item instantiation): out, rays and iters are
// per item, [n_out, n·spp] and [n·spp] (item = lane·spp + s, at most
// INT_MAX items), for bendy_fold_samples to fold, and a non-null
// `near_steps` [n·spp] int32 receives each item's RK4 step count. The LOOPM
// one takes its items from a pool shared by every LOOPM launch of the device,
// so two must not run at once. Not in the stub build.
#ifndef BENDY_PHASE_STUBS
int bendy_trace_geodesic(TRACE_ARGS, int n_mass, float eta, float min_step, float max_step,
                         float far, int max_steps, float growth, void* near_steps,
                         void* stream) {
  const bool loopm = (flags & FLAG_LOOPM) != 0;
  if (!(flags & FLAG_GEO) || (flags & FLAG_BVH) || n_mass < 1 ||
      (!loopm && n_mass > MAX_MASSES) || !items_ok(true, n, spp) || (flags >> STUB_SHIFT))
    return (int)cudaErrorInvalidValue;
  Params P = TRACE_PARAMS;
  P.n_mass = n_mass;
  P.eta = eta;
  P.min_step = min_step;
  P.max_step = max_step;
  P.far = far;
  P.max_steps = max_steps;
  P.growth = growth;
  P.near_steps = static_cast<int32_t*>(near_steps);
  const auto s = static_cast<cudaStream_t>(stream);
  return loopm ? launch<true, false, true>(P, want_aovs != 0, s)
               : launch<true, false>(P, want_aovs != 0, s);
}
#endif

// Launch the volume instantiation on `stream`: the density-grid stack
// `grid` [G,D,H,W] f32, march step and volume-bounce cap, trilinear or
// nearest lookups, per-lane volume-event counts into `vevents` [n] int32.
// With FLAG_GEO it is the geodesic one inside media (n_mass, FLAG_LOOPM,
// and the GeoParams as for bendy_trace_geodesic); without, n_mass is
// ignored, and FLAG_BVH walks the node block as for bendy_trace_surface,
// one thread per lane, or else the item instantiation runs. Per item,
// `vevents` is per item too. The stub build launches the item instantiation
// of the stub mask in `flags` (no geodesics, no BVH, FULL output, table in
// shared memory only).
int bendy_trace_volume(TRACE_ARGS, int n_mass, float eta, float min_step, float max_step,
                       float far, int max_steps, float growth, void* near_steps,
                       const void* grid, int G, int D, int H, int W, float volume_step,
                       int max_volume_bounces, int nearest, void* vevents, void* stream) {
  const bool geo = (flags & FLAG_GEO) != 0, loopm = (flags & FLAG_LOOPM) != 0,
             bvh = (flags & FLAG_BVH) != 0;
  if ((geo && (n_mass < 1 || (!loopm && n_mass > MAX_MASSES))) || (loopm && !geo) ||
      (geo && bvh) || !bvh_args_ok(flags, bvh0, table_floats) || !items_ok(geo || !bvh, n, spp) ||
      grid == nullptr || vevents == nullptr || G < 1 || D < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  Params P = TRACE_PARAMS;
  P.n_mass = geo ? n_mass : 0;
  P.eta = eta;
  P.min_step = min_step;
  P.max_step = max_step;
  P.far = far;
  P.max_steps = max_steps;
  P.growth = growth;
  P.near_steps = static_cast<int32_t*>(near_steps);
  P.grid = static_cast<const float*>(grid);
  P.vevents = static_cast<int32_t*>(vevents);
  P.G = G;
  P.D = D;
  P.H = H;
  P.W = W;
  P.volume_step = volume_step;
  P.max_volume_bounces = max_volume_bounces;
  P.nearest = nearest;
  const auto s = static_cast<cudaStream_t>(stream);
#ifdef BENDY_PHASE_STUBS
  if (geo || bvh || want_aovs || (flags & FLAG_GTAB)) return (int)cudaErrorInvalidValue;
  return launch_stub<true, false>(P, stub_mask(flags, true), s);
#else
  if (flags >> STUB_SHIFT) return (int)cudaErrorInvalidValue;
  if (!geo) {
    return bvh ? launch<false, true, false, true>(P, want_aovs != 0, s)
               : launch<false, true>(P, want_aovs != 0, s);
  }
  return loopm ? launch<true, true, true>(P, want_aovs != 0, s)
               : launch<true, true>(P, want_aovs != 0, s);
#endif
}

// Fold one per-item launch's words on `stream` (fold_kernel): `samp`
// [n_out, n·spp] f32 and `cnt` [4, n·spp] int32 (rays, iters, vevents,
// near_steps) into `out` [n_out, n], `rays`, `iters` and the optional
// `vevents`, `near_steps` [n] int32; `first` = 0 carries on from their
// values, max_iters >= 0 counts lanes past it into `over_cap` [1] int32.
int bendy_fold_samples(const void* samp, const void* cnt, int n, int spp, int n_out, int first,
                       int max_iters, void* out, void* rays, void* iters, void* vevents,
                       void* near_steps, void* over_cap, void* stream) {
  if (n < 0 || spp < 1 || (n_out != 3 && n_out != 10) || samp == nullptr || cnt == nullptr ||
      out == nullptr || rays == nullptr || iters == nullptr ||
      (max_iters >= 0 && over_cap == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const size_t smem = sizeof(uint32_t) * 2 * FOLD_LANES * fold_stride(spp);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  fold_kernel<<<(n + FOLD_LANES - 1) / FOLD_LANES, FOLD_LANES, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(samp), static_cast<const int32_t*>(cnt), n, spp, n_out,
      first != 0, max_iters, static_cast<float*>(out), static_cast<int32_t*>(rays),
      static_cast<int32_t*>(iters), static_cast<int32_t*>(vevents),
      static_cast<int32_t*>(near_steps), static_cast<int32_t*>(over_cap));
  return (int)cudaGetLastError();
}

// The floats that a launch of bendy_trace_surface (neither FLAG_GEO nor
// `volumes`), bendy_trace_geodesic (FLAG_GEO without `volumes`) or
// bendy_trace_volume (`volumes`) with a table of `table_floats` and these
// primitive counts stages in shared memory unless FLAG_GTAB: the table and,
// for a launch without `volumes` or FLAG_BVH (SWEEP_ROWS with the table
// staged, geodesics among them), the sweep rows. The wrapper's choice of
// FLAG_GTAB reads it.
int bendy_staged_floats(int flags, int volumes, int table_floats, int n_sph, int n_rct,
                        int n_box) {
  Params P = {};
  P.table_floats = table_floats;
  P.n_sph = n_sph;
  P.n_rct = n_rct;
  P.n_box = n_box;
  return (int)staged_floats(P, sweeps_rows(volumes != 0, false, (flags & FLAG_BVH) != 0));
}

// The instantiation without the BVH that a launch of bendy_trace_surface
// (the surface one, one thread per lane), bendy_trace_geodesic or
// bendy_trace_volume (these two the item instantiations, or with FLAG_LOOPM
// the LOOPM ones, whose resident grid is these blocks on every SM) with a
// table of `table_floats` and these primitive counts (staged unless
// FLAG_GTAB) runs: out [3] int32 gets the blocks per SM its register budget
// asks for (__launch_bounds__; 0: none), the blocks one SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the SM count of the
// current device. Returns a CUDA error code. Not in the stub build.
#ifndef BENDY_PHASE_STUBS
int bendy_item_occupancy(int flags, int volumes, int want_aovs, int table_floats, int n_sph,
                         int n_rct, int n_box, void* out) {
  const bool geo = (flags & FLAG_GEO) != 0, aovs = want_aovs != 0, gtab = (flags & FLAG_GTAB) != 0;
  const bool loopm = geo && (flags & FLAG_LOOPM) != 0;
  if (out == nullptr || table_floats < 0) return (int)cudaErrorInvalidValue;
  Params P = {};
  P.flags = flags;
  P.table_floats = table_floats;
  P.n_sph = n_sph;
  P.n_rct = n_rct;
  P.n_box = n_box;
  const size_t smem = dynamic_smem(P, false, sweeps_rows(volumes != 0, false, false));
  void (*kernel)(Params) =
      volumes ? (loopm ? instance<true, true, true>(aovs, gtab)
                 : geo ? instance<true, true>(aovs, gtab)
                       : instance<false, true>(aovs, gtab))
              : (loopm ? instance<true, false, true>(aovs, gtab)
                 : geo ? instance<true, false>(aovs, gtab)
                       : instance<false, false>(aovs, gtab));
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int* o = static_cast<int*>(out);
  o[0] = volumes ? (loopm ? min_blocks<true, true, true>(aovs, gtab)
                    : geo ? min_blocks<true, true>(aovs, gtab)
                          : min_blocks<false, true>(aovs, gtab))
                 : (loopm ? min_blocks<true, false, true>(aovs, gtab)
                    : geo ? min_blocks<true, false>(aovs, gtab)
                          : min_blocks<false, false>(aovs, gtab));
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[1], kernel, BLOCK, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&o[2], cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// The lane pool of a bendy_trace_surface launch of `n` lanes of `spp`
// samples in FULL output (want_aovs 0) with a table of `table_floats` and
// these primitive counts, staged unless FLAG_GTAB: out [2] int32 gets
// whether it runs the lane pool (pools_lanes) and the pool's resident
// threads on the current device (0 where the output, FLAG_GTAB or FLAG_BVH
// rule it out). Returns a CUDA error code. Not in the stub build.
int bendy_lane_pool(int flags, int want_aovs, int table_floats, int n_sph, int n_rct, int n_box,
                    int n, int spp, void* out) {
  if (out == nullptr || table_floats < 0 || n < 0) return (int)cudaErrorInvalidValue;
  Params P = {};
  P.flags = flags;
  P.table_floats = table_floats;
  P.n_sph = n_sph;
  P.n_rct = n_rct;
  P.n_box = n_box;
  int* o = static_cast<int*>(out);
  const cudaError_t e = lane_pool_threads(P, want_aovs != 0, &o[1]);
  o[0] = pools_lanes(n, spp, o[1]);
  return (int)e;
}
#endif

#ifdef BENDY_SWEEP_STATS
// Copy the measuring build's lane-pool counts to host `draws` (1 uint64:
// the draws since the last call, then zeroed) and `trips` (`threads` int32:
// each thread's loop trips in the last lane-pool launch, at most
// LANE_POOL_STATS_THREADS).
int bendy_lane_pool_stats(void* draws, void* trips, int threads) {
  if (threads < 0 || threads > LANE_POOL_STATS_THREADS) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyFromSymbol(draws, lane_pool_draws, sizeof(lane_pool_draws));
  static const unsigned long long zero = 0;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(lane_pool_draws, &zero, sizeof(zero));
  if (e == cudaSuccess && threads > 0)
    e = cudaMemcpyFromSymbol(trips, lane_pool_trips, sizeof(int) * threads);
  return (int)e;
}

// Copy the measuring build's sweep counts (3 uint64: rect tests, lane
// skips, warp skips) to host `out` and zero them.
int bendy_sweep_stats(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, sweep_stats, sizeof(sweep_stats));
  static const unsigned long long zero[3] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(sweep_stats, zero, sizeof(zero));
  return (int)e;
}
#endif

const char* bendy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
