"""The LOOPM tracer's item pool on the CPU: the plain model of its warp use
(``ops/trace_kernel.warp_use_pool_plain``) against the static count of one
item a thread (``warp_use_plain``), and the launch glue that hands the
warp-use pair to the LOOPM tracer, whose folds then count nothing, while
every other per-item launch's fold keeps counting.
"""

import pytest
import torch

from bendy_tpu_torch.geodesic import GeoParams
from bendy_tpu_torch.ops import trace_kernel
from bendy_tpu_torch.ops.trace_kernel import warp_use_plain, warp_use_pool_plain
from bendy_tpu_torch.ops.wavefront import TraceConfig


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


GLUE = {
    "looped_masses": (_cfg(geodesic=True, looped_masses=True), "tracer"),
    "looped_masses_in_media": (_cfg(geodesic=True, looped_masses=True, has_volumes=True),
                               "tracer"),
    "unrolled_masses": (_cfg(geodesic=True), "fold"),
    "media": (_cfg(has_volumes=True), "fold"),
}


@pytest.mark.parametrize("case", sorted(GLUE))
def test_the_warp_use_pair_goes_to_the_tracer_on_the_loopm_path(monkeypatch, case):
    """``_traced`` hands ``loop_use`` to a LOOPM launch as its last argument
    and folds its samples without it; the item launches of unrolled masses
    and of media pass a null there and count in their folds, in every
    chunk of samples."""
    cfg, counter = GLUE[case]
    launched, folded = [], []

    def launch(entry, who, table, cts, cam, pix, sub, *args, extra=(), outs=None, **kw):
        launched.append(extra[-1])
        return outs

    def fold(*args, loop_use=None, **kw):
        folded.append(loop_use)

    monkeypatch.setattr(trace_kernel, "_launch", launch)
    monkeypatch.setattr(trace_kernel, "fold_samples", fold)
    monkeypatch.setattr(trace_kernel, "SPLIT_BUDGET_BYTES", 1)  # chunks of one sample
    use = torch.zeros(2, dtype=torch.int64)
    pix = torch.arange(8, dtype=torch.int32)
    trace_kernel._traced("entry", None, None, {}, None, pix, pix, 4, 2, 3, 3, 1, (0, 0), 0, cfg,
                         lambda near, vev: (near, vev), loop_use=use)
    assert len(launched) == len(folded) == 3  # one sample a chunk
    want = (use, None) if counter == "tracer" else (None, use)
    assert all(a is want[0] for a in launched) and all(b is want[1] for b in folded)
    assert trace_kernel.pools_items(cfg) == (counter == "tracer")


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
