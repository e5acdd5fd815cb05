"""Port parity for the two ceiling probes (bendy_tpu_torch/tools).

Each probe's plain version is held to the reference tool's own Pallas
kernel (``_build`` of tools/vpu_peak.py and tools/mxu_shape_probe.py), run
in interpret mode on the CPU, at small sizes: rows 8, iters 8 for the FP32
chain (rtol 1e-5: the f64 emulation of an FMA against XLA's CPU
arithmetic), n 128, iters 4 for the dot chain (exact: every product and
sum is exact in f32 at the tool's values). The CUDA kernels need a card;
chip_smoke.py holds them to these plain versions there.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bendy_tpu_torch.tools import mxu_shape_probe, vpu_peak

_TOOLS = Path(__file__).resolve().parent.parent / "tools"


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
