"""The tracer's warp-use count and the LOOPM tracer's item pool: on the CPU
the plain model of the pool's warp use (``ops/trace_kernel.warp_use_pool_plain``)
against the static count of one item a thread (``warp_use_plain``), and the
launch glue that hands the warp-use pair to every tracer launch (surface, BVH,
item and LOOPM) and to no fold; on a card (``-m card``) each launch's own
count against ``warp_use`` of its threads' iterations.
"""

import pytest
import torch

from bendy_tpu_torch.geodesic import GeoParams
from bendy_tpu_torch.ops import trace_kernel
from bendy_tpu_torch.ops.trace_kernel import warp_use_plain, warp_use_pool_plain
from bendy_tpu_torch.ops.wavefront import TraceConfig
from torch_threads import one_intra_op_thread  # noqa: F401


def counts(fn, iters, *args):
    use = torch.zeros(2, dtype=torch.int64)
    fn(torch.tensor(iters, dtype=torch.int32), use, *args)
    return use.tolist()


@pytest.mark.parametrize("threads", [32, 64, 96, 4096])
def test_items_of_equal_length_issue_the_static_count(threads):
    """Every warp's threads end together, so the pool issues what one item a
    thread issues, whether a thread takes one item or several."""
    iters = [13] * 192
    assert counts(warp_use_pool_plain, iters, threads) == counts(warp_use_plain, iters)


def test_a_long_item_no_longer_holds_its_warp():
    """One 258-iteration item among 13-iteration ones: one item a thread, its
    warp issues 258 iterations in every lane; the pool's other threads take
    the rest of the items meanwhile, so the pool issues fewer iterations
    for the same thread iterations."""
    iters = [13] * 256
    iters[5] = 258
    static = counts(warp_use_plain, iters)
    pool = counts(warp_use_pool_plain, iters, 64)
    assert pool[0] == static[0] == 255 * 13 + 258
    assert static[1] == 32 * (258 + 7 * 13)
    assert pool[1] < static[1]
    # thread 5 keeps its long item; the other 63 take the other 255 items in
    # rounds of 13 iterations: threads 0-2 five, the rest of both warps four
    assert pool[1] == 32 * 258 + 32 * 4 * 13


def test_free_threads_take_the_next_items_in_order():
    """The earliest free thread takes the next item, ties in thread order:
    threads 0 and 1 of a 32-thread warp take items 32 and 33 at iteration 1,
    thread 0 item 34 at iteration 3."""
    iters = [1, 1] + [9] * 30 + [2, 7, 5]
    use = counts(warp_use_pool_plain, iters, 32)
    # thread 0: 1 + 2 + 5 = 8, thread 1: 1 + 7 = 8, the rest 9 each
    assert use == [sum(iters), 32 * 9]


def _cfg(**kw):
    return TraceConfig(max_bounces=2, geo=GeoParams(max_steps=64), **kw)


# (config, table counts, launches of a 3-sample call in chunks of one sample)
GLUE = {
    "looped_masses": (_cfg(geodesic=True, looped_masses=True), {}, 3),
    "looped_masses_in_media": (_cfg(geodesic=True, looped_masses=True, has_volumes=True), {}, 3),
    "unrolled_masses": (_cfg(geodesic=True), {}, 3),
    "media": (_cfg(has_volumes=True), {}, 3),
    "media_bvh": (_cfg(has_volumes=True), {"bvh0": 0}, 1),
    "surface": (_cfg(), {}, 1),
    "surface_bvh": (_cfg(), {"bvh0": 0}, 1),
}


@pytest.mark.parametrize("case", sorted(GLUE))
def test_the_warp_use_pair_goes_to_the_tracer_on_the_loopm_path(monkeypatch, case):
    """Every tracer launch gets ``loop_use``, the LOOPM one as on every other
    path: the surface and BVH launches (one thread a lane) and the item and
    LOOPM launches in every chunk of samples, whose folds take no pair."""
    cfg, counts, launches = GLUE[case]
    launched, folded = [], []

    def launch(entry, who, table, cts, cam, pix, sub, *args, outs=None, loop_use=None, **kw):
        launched.append(loop_use)
        return outs

    def fold(*args, **kw):
        folded.append(kw)

    monkeypatch.setattr(trace_kernel, "_launch", launch)
    monkeypatch.setattr(trace_kernel, "fold_samples", fold)
    monkeypatch.setattr(trace_kernel, "SPLIT_BUDGET_BYTES", 1)  # chunks of one sample
    use = torch.zeros(2, dtype=torch.int64)
    pix = torch.arange(8, dtype=torch.int32)
    if cfg.geodesic or cfg.has_volumes:
        trace_kernel._traced("entry", None, None, counts, None, pix, pix, 4, 2, 3, 3, 1, (0, 0), 0,
                             cfg, lambda near, vev: (near, vev), loop_use=use)
    else:
        trace_kernel.trace_surface(None, counts, None, pix, pix, width=4, height=2, spp=3,
                                   spp_total=3, subsample=1, key=(0, 0), sample0=0, cfg=cfg,
                                   loop_use=use)
    assert len(launched) == launches and all(a is use for a in launched)
    per_item = trace_kernel.per_item(cfg, "bvh0" in counts)
    assert len(folded) == (launches if per_item else 0)
    assert not any("loop_use" in f for f in folded)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tracer kernel runs only there")
    return torch.device("cuda")


# (scene, width, height, spp): cornell's lane loop with a ragged last warp
# (80 lanes), blackhole's item launch over unrolled masses, mass_cluster's
# LOOPM launch with fewer items than its resident grid holds (so no thread
# takes a second item) and a ragged last warp
CARD = {
    "lane_loop": ("cornell", 10, 8, 2),
    "item": ("blackhole", 16, 16, 4),
    "loopm": ("mass_cluster", 10, 8, 1),
}


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CARD))
def test_the_tracers_own_count_is_warp_use_of_its_threads(card, case):
    """A launch's warp-use pair, counted by the tracer itself, equals
    ``warp_use`` of the same key's per-thread iterations in launch order,
    integer for integer."""
    from bendy_tpu_torch import Renderer, load_scene
    from bendy_tpu_torch.ops.trace_kernel import make_tracer, per_item, warp_use
    from bendy_tpu_torch.tools.perf_report import thread_counts

    name, W, H, spp = CARD[case]
    scene = load_scene(f"scenes/{name}.json.gz")
    cam = scene.find_by_tag("camera")
    scene.get_object(cam).inner.aspect_ratio = W / H
    r = Renderer(scene, device=card)
    r.camera_params(cam)  # packs the camera the tracer reads
    cfg = r.trace_config(r.config, cam)
    assert trace_kernel.pools_items(cfg) == (case == "loopm")
    assert per_item(cfg) == (case != "lane_loop")
    tracer = make_tracer(r.arrays, W, H, spp, 1, cfg)
    pix = torch.arange(W * H, dtype=torch.int32, device=card)
    sub = torch.zeros_like(pix)
    use = torch.zeros(2, dtype=torch.int64, device=card)
    tracer.words(r._cam_packed, 5, 0, pix, sub, loop_use=use)
    res = tracer(r._cam_packed, 5, 0, pix, sub, count_items=per_item(cfg))
    _, iters = thread_counts(res, pix.numel(), spp, cfg)
    assert use.tolist() == warp_use(iters.cpu()).tolist()
    assert 0 < use[0] <= use[1]


@pytest.mark.parametrize("looped", [False, True])
def test_a_loopm_table_leaves_room_for_the_threads_counts(looped):
    """A LOOPM block holds its threads' loop counts in static shared memory
    beside the staged table, so a table that just fits a block's shared
    memory stays in global memory on the LOOPM path and only there."""
    from bendy_tpu_torch import _build

    staged = (trace_kernel.MAX_TABLE_BYTES - 4 * _build.TRACE_BLOCK) // 4 + 1
    lib = type("Lib", (), {"bendy_staged_floats": staticmethod(lambda *a: staged)})
    cfg = _cfg(geodesic=True, looped_masses=looped)
    assert trace_kernel.stays_in_global(lib, cfg, staged, {}) == looped
