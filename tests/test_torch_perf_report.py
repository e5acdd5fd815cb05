"""The port's perf tools on the CPU (no card, no timing): the op count of
the plain loop body (``tools/perf_report.loop_body_ops``) against the
reference's band and the reference's own count (tests/test_tools.py), the
counting conventions, the report's arithmetic from fixed counts, the
per-thread issue count, and block_sweep's parser; both tools refuse to run
without a card."""

import sys
from pathlib import Path

import pytest
import torch

from bendy_tpu_torch.ops.wavefront import TraceConfig
from bendy_tpu_torch.tools import block_sweep, perf_report
from torch_threads import one_intra_op_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))


def test_loop_body_ops_cornell_against_the_reference():
    """The production cornell loop: inside the reference's band (a 2x move
    means the loop body or the conventions changed) and within 0.5-2x of
    the reference's jaxpr count of its own loop body."""
    from perf_report import loop_body_ops as ref_loop_body_ops

    info = perf_report.loop_body_ops("cornell")
    ops = info["ops_per_lane_iter"]
    assert 400 < ops < 4000
    ref = ref_loop_body_ops("cornell")["vpu_ops_per_lane_iter"]
    assert 0.5 < ops / ref < 2.0, (ops, ref)
    assert info["mxu_flops_per_lane_iter"] == 0
    assert info["mask_ops_per_lane_iter"] > 0 and info["load_ops_per_lane_iter"] > 0
    n_a, n_b = info["iterations"]
    assert n_b > n_a > 0 and n_a % 8 == 0 and n_b % 8 == 0
    cfg = info["cfg"]
    assert not cfg.has_volumes and not cfg.geodesic and not cfg.want_aovs
    assert not info["bvh_walk"]


def test_op_counter_conventions():
    x = torch.arange(8, dtype=torch.int64)
    f, g = torch.rand(4, 3), torch.rand(3, 5)
    with perf_report.OpCounter() as c:
        y = (x * 3) & 0xFFFFFFFF  # 8 ops, 8 mask ops
        y.view(2, 4).t()  # layout: 0
        x.sum()  # a reduction: 8, per input element
        x.float()  # a convert: 8
        torch.where(x > 3, x, 0)  # compare 8, select 8
        torch.tensor([1.0, 2.0, 3.0])[x % 3]  # remainder 8, the gather a load of 8
        f @ g  # 2·4·3·5
        torch.zeros(5)
    assert (c.ops, c.masks, c.loads, c.matmul) == (8 + 8 + 8 + 16 + 8, 8, 8, 120)


def test_report_row_arithmetic():
    info = {"scene": "cornell", "ops_per_lane_iter": 1500.0, "mask_ops_per_lane_iter": 70.0,
            "load_ops_per_lane_iter": 50.0, "mxu_flops_per_lane_iter": 0.0, "samples": (1, 4),
            "iterations": (8, 16), "lanes": 32, "bvh_walk": False}
    m = {"warp_iters_per_sec": 4e11 / 32, "thread_iters_per_sec": 4e11,
         "live_thread_iters_per_sec": 3e11, "rays_per_sec": 3.2e11, "sm_clock_mhz": 1980.0,
         "threads_per_block": 128}
    issue = 132 * 128 * 1980e6
    row = perf_report.report_row(info, m, 5.92e13, issue)
    assert row["sustained_ops_per_sec"] == pytest.approx(4.5e14)  # live x ops
    assert row["sustained_ops_per_sec_issued"] == pytest.approx(6e14)
    assert row["fp32_utilization_lo"] == pytest.approx(4.5e14 / (2 * issue))
    assert row["fp32_utilization_hi"] == pytest.approx(4.5e14 / issue)
    assert row["fp32_util_vs_measured_peak"] == pytest.approx(4.5e14 / 5.92e13)
    assert row["occupancy"] == pytest.approx(0.8)
    assert row["mrays_per_sec"] == pytest.approx(3.2e5)
    assert row["mxu_utilization"] == 0.0
    assert "|" in perf_report.markdown([row])


def test_issued_thread_iterations_and_item_order():
    iters = torch.tensor([1, 5] + [2] * 30 + [3] * 32 + [7] * 5, dtype=torch.int32)
    assert perf_report.issued(iters) == 32 * 5 + 32 * 3  # the partial warp left out

    class Res:  # a per-item call of 2 lanes x 4 samples, chunks of one launch
        lane_counts = {"rays": None, "iters": None,
                       "item_rays": torch.arange(8).view(2, 4),
                       "item_iters": torch.arange(8).view(2, 4) + 10}

    rays, its = perf_report.thread_counts(Res, 2, 4, TraceConfig())
    assert rays.tolist() == list(range(8)) and its.tolist() == list(range(10, 18))


def test_block_sweep_parser():
    args = block_sweep.parse_args([])
    assert args.scenes == ["cornell", "cloud", "blackhole"]
    assert (args.threads, args.spp, args.res, args.subsample, args.max_bounces, args.repeats,
            args.no_tile) == ([64, 128, 256], 64, 256, 2, None, 4, False)
    args = block_sweep.parse_args(["scene", "--threads", "128", "--no-tile", "--out", "x.json",
                                   "--subsample", "1", "--max-bounces", "4"])
    assert (args.scenes, args.threads, args.no_tile, args.out, args.subsample,
            args.max_bounces) == (["scene"], [128], True, "x.json", 1, 4)


@pytest.mark.parametrize("main", [block_sweep.main, perf_report.main])
def test_tools_need_the_card(main):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the card-less refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["cornell"])
