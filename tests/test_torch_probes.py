"""Port parity for the two ceiling probes (bendy_tpu_torch/tools).

Each probe's plain version is held to the reference tool's own Pallas
kernel (``_build`` of tools/vpu_peak.py and tools/mxu_shape_probe.py), run
in interpret mode on the CPU, at small sizes: rows 8, iters 8 for the FP32
chain (rtol 1e-5: the f64 emulation of an FMA against XLA's CPU
arithmetic), n 128, iters 4 for the dot chain (exact: every product and
sum is exact in f32 at the tool's values). The dot chain's tile plan and
its ordered sum of split-K partials are checked here too, the plan against
the tiles and register budget the kernel's source declares. The CUDA kernels need a card;
chip_smoke.py holds them to these plain versions there.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bendy_tpu_torch.tools import mxu_shape_probe, vpu_peak
from torch_threads import one_intra_op_thread  # noqa: F401

_TOOLS = Path(__file__).resolve().parent.parent / "tools"
_PROBES_CU = (Path(__file__).resolve().parent.parent / "bendy_tpu_torch" / "csrc"
              / "probes.cu")


def _reference(name):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", _TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Run the reference tools' pallas_call in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("kind", ["fma", "nofma"])
def test_fp32_chain_matches_reference_tool(interpret, kind):
    ref = _reference("vpu_peak")
    rows, iters = 8, 8
    fn, x = ref._build(kind, rows, iters)
    want = np.asarray(fn(x))
    got = vpu_peak.fp32_chain(vpu_peak.probe_input(rows, "cpu"), kind, iters)
    assert got.shape == (rows, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype_name", ["bf16", "f32"])
def test_dot_chain_matches_reference_tool(interpret, dtype_name):
    """The f32 control rounds its dot's inputs to bf16, as DEFAULT precision
    does on the TPU; XLA's CPU dot does not round them, so there the
    reference's f32 control stays 1 ulp of 256 above (0.5 + pert, unrounded)
    and the port's control equals the reference's bf16 run instead."""
    ref = _reference("mxu_shape_probe")
    n, iters = 128, 4
    fn, tab, oh, _ = ref._build(n, iters, dtype_name)
    want = np.asarray(fn(tab, oh))
    ptab, poh = mxu_shape_probe.probe_inputs(n, dtype_name)
    np.testing.assert_array_equal(ptab.float().numpy(), np.asarray(tab, np.float32))
    np.testing.assert_array_equal(poh.float().numpy(), np.asarray(oh, np.float32))
    got = mxu_shape_probe.bf16_dot_chain(ptab, poh, iters)
    assert got.shape == (128, n) and got.dtype == torch.float32
    if dtype_name == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        fn, tab, oh, _ = ref._build(n, iters, "bf16")
        want = np.asarray(fn(tab, oh))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dot_chain_perturbation_rounds_each_iteration():
    """Off the tool's constants: random small tab values (k * 2**-14), whose
    bf16 spacing lies below the perturbation for small k, so the rounded
    operand changes from iteration to iteration; the plain chain equals
    the sum of its iterations done one by one, and the library yardstick
    computes the same sum (exact in f32 at these values)."""
    rng = np.random.default_rng(5)
    n, iters = 64, 3
    tab = torch.from_numpy(rng.integers(1, 64, (128, 512)).astype(np.float32)
                           * np.float32(2**-14)).to(torch.bfloat16)
    moved = (tab.float() + mxu_shape_probe.perturbation(2)).to(torch.bfloat16) != tab
    assert moved.any() and not moved.all()
    oh = torch.from_numpy(np.eye(512, n, dtype=np.float32)[rng.permutation(512)]).to(
        torch.bfloat16)
    got = mxu_shape_probe.bf16_dot_chain(tab, oh, iters)
    want = sum((tab.float() + mxu_shape_probe.perturbation(i)).to(torch.bfloat16).float()
               @ oh.float() for i in range(iters))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for chunk in (2, 64):  # two chunks, the last one short; one chunk
        lib = mxu_shape_probe.library_dot_chain(tab, oh, iters, chunk)
        torch.testing.assert_close(lib, got, rtol=0, atol=0)


def test_probe_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="kind"):
        vpu_peak.fp32_chain(torch.ones(4, 128), "fmac", 1)
    tab, oh = mxu_shape_probe.probe_inputs(100)
    with pytest.raises(ValueError, match="multiple"):
        mxu_shape_probe.bf16_dot_chain(tab, oh, 1)
    tab, oh = mxu_shape_probe.probe_inputs(64)
    with pytest.raises(ValueError, match="both"):
        mxu_shape_probe.bf16_dot_chain(tab, oh.float(), 1)
    assert vpu_peak.ops(2112, 10) == 2112 * 128 * 67 * 10
    assert vpu_peak.peak("nofma") == vpu_peak.peak("fma") / 2


def test_measure_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the card-less refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        vpu_peak.measure("fma")
    with pytest.raises(RuntimeError, match="cuda"):
        mxu_shape_probe.measure(1024)


def _kernel_tiles():
    """The (BN, KS) tiles the C entry point dispatches to, read from the source."""
    src = _PROBES_CU.read_text()
    return {(int(b), int(k)) for b, k in re.findall(r"BENDY_DOT_TILE\((\d+), (\d+)\)", src)}


@pytest.mark.parametrize("n", [64, 128, 192, 256, 320, 640, 832, 1024, 1088, 1152, 1280, 1664,
                               2048, 3072, 4096, 8192])
def test_dot_plan_tiles_n_and_k_within_the_register_budget(n):
    plan = mxu_shape_probe.dot_plan(n)
    # the column tiles cover n exactly: 256 wide where 256 divides n, else 64
    assert plan.bn * plan.tiles == n
    assert plan.bn == (256 if n % 256 == 0 else 64)
    # the depth slices tile K = 512, in whole 16-deep wgmma steps within one
    # 128-byte swizzled row of bf16
    assert plan.ks * plan.split == mxu_shape_probe.K and plan.ks % 16 == 0 and plan.ks <= 64
    assert (plan.bn, plan.ks) in _kernel_tiles()
    # a thread keeps BN/2 accumulators, KS/2 words of A fragments (4 a
    # 16-deep step, double-buffered) and KS/2 tab values: within the budget
    # the kernel's static_assert sets
    budget = re.search(r"static_assert\(BN / 2 \+ KS <= (\d+)", _PROBES_CU.read_text())
    assert plan.bn // 2 + plan.ks // 2 + plan.ks // 2 <= int(budget.group(1))
    assert plan.blocks == n // plan.bn * (512 // plan.ks)
    if n >= 1024 and n % 1024 == 0:  # the measured widths fill the SMs in whole waves
        assert plan.fill > 0.96


def test_dot_kernel_tiles_match_the_plan():
    """The plan picks every instantiated tile at some n and no other."""
    picked = {(p.bn, p.ks) for p in map(mxu_shape_probe.dot_plan, range(64, 8193, 64))}
    assert picked == _kernel_tiles() == {(256, 64), (256, 32), (256, 16), (64, 64)}


def test_dot_partials_sum_in_index_order():
    """f32 sums whose value depends on the order: index order gives 1, any
    other order 0 or 2."""
    vals = np.array([1e8, 1.0, -1e8, 1.0], dtype=np.float32)
    partial = torch.from_numpy(np.broadcast_to(vals[:, None, None], (4, 2, 3)).copy())
    want = np.float32(0)
    for v in vals:
        want = np.float32(want + v)
    assert want == 1.0
    got = mxu_shape_probe.sum_partials(partial)
    assert got.shape == (2, 3) and torch.all(got == 1.0)
    assert float(mxu_shape_probe.sum_partials(partial.flip(0))[0, 0]) != 1.0


@pytest.mark.parametrize("case", ["n_100", "n_1000", "n_0", "mixed_bf16_f32", "mixed_f32_bf16",
                                  "f16", "tab_shape", "onehot_rows", "onehot_1d"])
def test_dot_chain_refuses_what_the_kernel_does_not_take(case):
    n = {"n_100": 100, "n_1000": 1000, "n_0": 0}.get(case, 128)
    tab, oh = mxu_shape_probe.probe_inputs(max(n, 1) if n else 64)
    if case == "n_0":
        oh = oh[:, :0]
    elif case == "mixed_bf16_f32":
        oh = oh.float()
    elif case == "mixed_f32_bf16":
        tab = tab.float()
    elif case == "f16":
        tab, oh = tab.half(), oh.half()
    elif case == "tab_shape":
        tab = tab[:64]
    elif case == "onehot_rows":
        oh = oh[:256]
    elif case == "onehot_1d":
        oh = oh[:, 0].contiguous()
    with pytest.raises(ValueError):
        mxu_shape_probe.bf16_dot_chain(tab, oh, 1)
    if case.startswith("n_"):
        with pytest.raises(ValueError, match="multiple"):
            mxu_shape_probe.dot_plan(n)
