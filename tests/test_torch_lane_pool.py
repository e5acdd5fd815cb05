"""The surface tracer's lane pool: on the CPU the shape rule's mirror
(``ops/trace_kernel.pools_lanes``) against the kernel's, the pool model's
warp use (``warp_use_pool_plain``) over lanes of several samples against a
lane-loop pool stepped one iteration at a time, and the launch glue that
hands a pooled launch the warp-use pair and a counter of its own; on a card
(``-m card``) the pooled launch bit-equal to one thread a lane, alone, two
at once on two streams and past a LOOPM launch, its own warp-use count and
its draws (the measuring build).
"""

import math
import os
import re

import pytest
import torch

from bendy_tpu_torch.geodesic import GeoParams
from bendy_tpu_torch.ops import trace_kernel
from bendy_tpu_torch.ops.trace_kernel import pools_lanes, warp_use, warp_use_pool_plain
from bendy_tpu_torch.ops.wavefront import TraceConfig
from torch_threads import one_intra_op_thread  # noqa: F401

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "bendy_tpu_torch", "csrc", "trace_surface.cu")
# the H100's resident grid of the lane pool: 8 blocks of 128 on each of 132 SMs
H100_THREADS = 8 * 128 * 132
# the benchmark's cornell cells: 768x512 at 2x2 (progressive), 256x256 at 2x2 (batch)
PROGRESSIVE_LANES, BATCH_LANES = 768 * 512 * 4, 256 * 256 * 4


def _cfg(**kw):
    return TraceConfig(**{"want_aovs": False, **kw})  # FULL output, as the benchmark renders


def test_the_mirror_keeps_the_kernels_thresholds():
    """One rule in two homes: the mirror's LANE_POOL_MIN and LANE_POOL_SPP
    are the kernel's."""
    with open(SOURCE) as f:
        src = f.read()
    m = re.search(r"constexpr int LANE_POOL_MIN = (\d+), LANE_POOL_SPP = (\d+);", src)
    assert (int(m.group(1)), int(m.group(2))) == (trace_kernel.LANE_POOL_MIN,
                                                  trace_kernel.LANE_POOL_SPP)


def test_progressive_pools_and_batch_stays_static():
    """cornell.progressive's launch holds 11.6 one-sample lanes a resident
    thread and runs the lane pool; cornell.batch's holds 1.94 lanes of 64
    samples and keeps one thread a lane, and would at 1 sample too; the
    thresholds themselves pool; lanes of more samples than LANE_POOL_SPP
    never do."""
    cfg = _cfg()
    k, cap = trace_kernel.LANE_POOL_MIN, trace_kernel.LANE_POOL_SPP
    assert pools_lanes(cfg, PROGRESSIVE_LANES, 1, H100_THREADS)
    assert not pools_lanes(cfg, BATCH_LANES, 64, H100_THREADS)
    assert not pools_lanes(cfg, BATCH_LANES, 1, H100_THREADS)
    assert pools_lanes(cfg, k * H100_THREADS, cap, H100_THREADS)
    assert not pools_lanes(cfg, k * H100_THREADS - 1, 1, H100_THREADS)
    assert not pools_lanes(cfg, PROGRESSIVE_LANES, cap + 1, H100_THREADS)
    assert not pools_lanes(cfg, PROGRESSIVE_LANES, 1, 0)  # the pool does not fit the card


@pytest.mark.parametrize("route", ["geodesic", "looped_masses", "media", "bvh", "gtab", "aovs"])
def test_other_launches_never_pool(route):
    """Geodesic, media, BVH, GTAB and AOV launches never take the lane pool,
    however many lanes a thread they hold."""
    kw, bvh, gtab = {}, route == "bvh", route == "gtab"
    if route in ("geodesic", "looped_masses"):
        kw = dict(geodesic=True, looped_masses=route == "looped_masses", geo=GeoParams())
    elif route == "media":
        kw = dict(has_volumes=True)
    elif route == "aovs":
        kw = dict(want_aovs=True)
    assert not pools_lanes(_cfg(**kw), 100 * H100_THREADS, 1, H100_THREADS, bvh=bvh, gtab=gtab)


def stepped_pool(paths, cap: int, threads: int) -> list[int]:
    """Each thread's loop trips in a lane-loop pool stepped one iteration at
    a time: ``paths`` [lanes][samples] the iterations of each sample's path;
    a thread traces its lane's samples in order, the lane cut at ``cap``
    iterations, then the free threads take the next lanes in thread order."""
    lanes = len(paths)
    left = [min(sum(p), cap) for p in paths]  # a lane's iterations, cut at the cap
    trips, cur = [0] * threads, list(range(threads))
    nxt = threads
    while any(c is not None for c in cur):
        for t in range(threads):  # one iteration of every busy thread
            if cur[t] is not None:
                left[cur[t]] -= 1
                trips[t] += 1
        for t in range(threads):  # the threads whose lane ended take the next
            if cur[t] is not None and left[cur[t]] == 0:
                cur[t], nxt = (nxt, nxt + 1) if nxt < lanes else (None, nxt)
    return trips


@pytest.mark.parametrize("threads", [32, 64, 96])
def test_the_pool_model_counts_a_lane_loop_pool(threads):
    """warp_use_pool_plain over lanes of several samples (each lane's
    iterations summed over its samples, cut at the cap) gives what a
    lane-loop pool stepped one iteration at a time issues, cut lanes
    included."""
    gen = torch.Generator().manual_seed(threads)
    spp, cap, lanes = 4, 19, 5 * threads + 7
    paths = torch.randint(1, 10, (lanes, spp), generator=gen).tolist()
    iters = torch.tensor([min(sum(p), cap) for p in paths], dtype=torch.int32)
    assert (iters == cap).any() and (iters < cap).any()
    model = torch.zeros(2, dtype=torch.int64)
    warp_use_pool_plain(iters, model, threads)
    want = warp_use(torch.tensor(stepped_pool(paths, cap, threads)))
    assert model.tolist() == want.tolist()
    assert model[0] == iters.sum()


def test_the_glue_hands_the_pair_to_a_pooled_launch(monkeypatch):
    """A surface launch at cornell.progressive's shape, which the kernel
    pools, gets the pass's warp-use pair like any other launch, once, and a
    one-word int32 counter on the lanes' device for the pool's draws, a new
    one each launch, so no two launches share it."""
    cfg = _cfg()
    launched = []

    def launch(entry, who, table, cts, cam, pix, sub, *args, extra=(), outs=None,
               loop_use=None, **kw):
        launched.append((entry, pix.numel(), loop_use, extra))

    monkeypatch.setattr(trace_kernel, "_launch", launch)
    use = torch.zeros(2, dtype=torch.int64)
    pix = torch.zeros(PROGRESSIVE_LANES, dtype=torch.int32)
    assert pools_lanes(cfg, pix.numel(), 1, H100_THREADS)
    for _ in range(2):
        trace_kernel.trace_surface(None, {}, None, pix, pix, width=768, height=512, spp=1,
                                   spp_total=1, subsample=2, key=(0, 0), sample0=0, cfg=cfg,
                                   loop_use=use)
    assert [x[:2] for x in launched] == [("bendy_trace_surface", PROGRESSIVE_LANES)] * 2
    assert all(x[2] is use for x in launched)
    counters = [x[3] for x in launched]
    for (c,) in counters:
        assert c.shape == (1,) and c.dtype == torch.int32 and c.device == pix.device
    assert counters[0][0].data_ptr() != counters[1][0].data_ptr()


# --- on a card ----------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell():
    """(tracer factory, lanes of 768x512 at 2x2, the renderer, its config,
    the lane pool's resident threads) of cornell on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tracer kernel runs only there")
    from bendy_tpu_torch import Renderer, load_scene
    from bendy_tpu_torch.bench import renderer_lanes
    from bendy_tpu_torch.ops.trace_kernel import lane_pool, make_tracer, tracer_table

    dev = torch.device("cuda")
    W, H, n = 768, 512, 2
    scene = load_scene("scenes/cornell.json.gz")
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = W / H
    r = Renderer(scene, device=dev)
    r.camera_params(cam)
    cfg = r.trace_config(r.config, cam)
    pix, sub = renderer_lanes(r, cfg, W, H, 1, n)
    table_np, counts = tracer_table(r.arrays.host_copy(), cfg)
    pooled, threads = lane_pool(cfg, table_np.size, counts, pix.numel(), 1)
    assert pooled and threads > 0

    def tracer(spp):
        return make_tracer(r.arrays, W, H, spp, n, cfg)

    return tracer, pix, sub, r, cfg, threads


def words(tracer, r, pix, sub, seed):
    res = tracer(r._cam_packed, seed, 0, pix, sub)
    return (torch.stack([*res.radiance]), res.lane_counts["rays"], res.lane_counts["iters"])


def static_words(tracer, r, pix, sub, seed, threads):
    """The same lanes in launches too small for the pool: one thread a lane."""
    step = trace_kernel.LANE_POOL_MIN * threads - 1
    parts = [words(tracer, r, pix[i:i + step], sub[i:i + step], seed)
             for i in range(0, pix.numel(), step)]
    return tuple(torch.cat([p[k] for p in parts], dim=-1) for k in range(3))


@pytest.mark.card
@pytest.mark.parametrize("spp,ragged", [(1, False), (1, True), (4, True),
                                        (trace_kernel.LANE_POOL_SPP, True)])
def test_pooled_launch_is_bit_equal_to_one_thread_a_lane(cornell, spp, ragged):
    """Films (the lanes' channel sums), rays and iterations of a pooled
    launch equal those of one thread a lane bit for bit, at 1, 4 and
    LANE_POOL_SPP (the most a pooled lane holds) samples a lane, over all
    768x512x4 lanes or a count past the threshold that is a multiple of
    neither 32 nor the block."""
    make, pix, sub, r, cfg, threads = cornell
    lanes = trace_kernel.LANE_POOL_MIN * threads + 37 if ragged else pix.numel()
    pix, sub = pix[:lanes].contiguous(), sub[:lanes].contiguous()
    assert pools_lanes(cfg, lanes, spp, threads)
    assert not ragged or (lanes % 32 and lanes % 128)
    tracer = make(spp)
    seed = 2**31 + 17 * spp
    pooled = words(tracer, r, pix, sub, seed)
    static = static_words(tracer, r, pix, sub, seed, threads)
    for a, b in zip(pooled, static):
        assert torch.equal(a, b)


@pytest.mark.card
def test_two_pooled_launches_at_once_on_two_streams(cornell):
    """Two pooled launches running at once on two streams, each over the
    whole frame at its own seed, give the words each gives alone: each
    launch draws its lanes from a counter of its own."""
    make, pix, sub, r, cfg, threads = cornell
    tracer = make(1)
    alone = [words(tracer, r, pix, sub, seed) for seed in (11, 12)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    main = torch.cuda.current_stream()
    for s in streams:
        s.wait_stream(main)
    both = []
    for s, seed in zip(streams, (11, 12)):
        with torch.cuda.stream(s):
            both.append(words(tracer, r, pix, sub, seed))
    for s in streams:
        main.wait_stream(s)
    torch.cuda.synchronize()
    for a, b in zip(alone, both):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.card
def test_the_pool_resets_for_the_next_launch_past_a_loopm_launch(cornell):
    """Two pooled launches with a LOOPM launch between (its own item pool)
    give the same words: each pooled launch starts its own counter at 0,
    and LOOPM's pool is back at 0 for its next launch."""
    from bendy_tpu_torch import Renderer, load_scene
    from bendy_tpu_torch.ops.trace_kernel import make_tracer, pools_items

    make, pix, sub, r, cfg, threads = cornell
    tracer = make(1)
    first = words(tracer, r, pix, sub, 99)
    scene = load_scene("scenes/mass_cluster.json.gz")
    cam = scene.find_by_tag("camera")
    m = Renderer(scene, device=pix.device)
    m.camera_params(cam)
    mcfg = m.trace_config(m.config, cam)
    assert pools_items(mcfg)
    mpix = torch.arange(96 * 64, dtype=torch.int32, device=pix.device)
    loopm = make_tracer(m.arrays, 96, 64, 2, 1, mcfg)
    a = loopm(m._cam_packed, 5, 0, mpix, torch.zeros_like(mpix))
    second = words(tracer, r, pix, sub, 99)
    b = loopm(m._cam_packed, 5, 0, mpix, torch.zeros_like(mpix))
    for x, y in zip(first, second):
        assert torch.equal(x, y)
    assert torch.equal(a.radiance.x, b.radiance.x) and torch.equal(a.lane_counts["iters"],
                                                                    b.lane_counts["iters"])


@pytest.mark.card
@pytest.mark.parametrize("spp", [1, 4])
def test_the_pools_own_count_and_its_draws(cornell, spp):
    """Through the measuring build: the pooled launch's warp-use pair, counted
    by the tracer itself, equals warp_use of its threads' loop trips (each
    its lanes' iterations summed), which sum the lanes' iterations; the
    launch draws a run of 32 lanes for each run past the threads' first
    lanes, and each warp but the one that drew the last run draws once
    more, past the lanes: fewer draws than lanes / 32."""
    import ctypes

    from bendy_tpu_torch.tools import sweep_sass

    make, pix, sub, r, cfg, threads = cornell
    lanes = trace_kernel.LANE_POOL_MIN * threads + 37
    pix, sub = pix[:lanes].contiguous(), sub[:lanes].contiguous()
    tracer = make(spp)
    lib = sweep_sass.stats_library()
    draws = (ctypes.c_ulonglong * 1)()
    trips = torch.zeros(threads, dtype=torch.int32)
    use = torch.zeros(2, dtype=torch.int64, device=pix.device)
    with sweep_sass.measuring(lib):
        assert lib.bendy_lane_pool_stats(ctypes.addressof(draws), None, 0) == 0  # zero the draws
        tracer.words(r._cam_packed, 3, 0, pix, sub, loop_use=use)
        torch.cuda.synchronize()
        assert lib.bendy_lane_pool_stats(ctypes.addressof(draws), trips.data_ptr(), threads) == 0
        iters = tracer(r._cam_packed, 3, 0, pix, sub).lane_counts["iters"]
    assert use.tolist() == warp_use(trips).tolist()
    assert int(trips.sum()) == int(iters.sum())
    assert draws[0] == math.ceil((lanes - threads) / 32) + threads // 32 - 1
    assert draws[0] < lanes / 32


@pytest.mark.card
def test_the_mirror_agrees_with_the_library(cornell):
    """The library's choice (bendy_lane_pool) is the mirror's at and around
    both thresholds, and at the benchmark's two cornell shapes."""
    from bendy_tpu_torch.ops.trace_kernel import lane_pool, tracer_table

    make, pix, sub, r, cfg, threads = cornell
    table_np, counts = tracer_table(r.arrays.host_copy(), cfg)
    k, cap = trace_kernel.LANE_POOL_MIN, trace_kernel.LANE_POOL_SPP
    for lanes, spp in ((k * threads - 1, 1), (k * threads, 1), (k * threads, cap),
                       (k * threads, cap + 1), (PROGRESSIVE_LANES, 1), (BATCH_LANES, 64)):
        assert lane_pool(cfg, table_np.size, counts, lanes, spp) == (
            pools_lanes(cfg, lanes, spp, threads), threads)
