"""The phase probe's plain stubs on the CPU (no card, no timing).

``bendy_tpu_torch/tools/phase_probe.py`` keeps its own copy of the
reference's stand-ins (``tools/phase_probe.py::_stubs``). For each phase,
the port's plain ``trace_core`` with the port's stubs patched in is held to
the reference's ``trace_core`` with the reference's own stubs patched in:
cornell at 16x16, 4 spp, max_bounces 3 for light, shade, sweep, rng, camera
and floor; the volume scene at 16x16, 1 spp, max_bounces 3 for volume and
marchspec; seed 7. Per lane rtol 5e-4 / atol 1e-5 and equal rays, the
port's standing per-lane tolerance. The reference runs without jit, so no
cached trace of the unstubbed loop can serve it, and with 1/sqrt in place
of its rsqrt, as ``tests/test_torch_looped.py`` runs it (XLA's CPU rsqrt is
not correctly rounded); so run, it agrees with the port bit for bit. Each
stub must change the trace, or it stubbed nothing.

Also: every (module, attr) the port's stubs patch exists; the phase masks
are the kernel's (``csrc/trace_surface.cu``) and each is one its stub build
instantiates; the phase split's arithmetic on fixed numbers; the stub
build's flags, sources, hash and ptxas labels; the march share from the
plain loop's counters; unknown phases refused; the tools need a card and
import no JAX. The CUDA stub build itself is held to these plain stubs on
the card (``chip_smoke.py`` phase 19(a)).
"""

import functools
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bendy_tpu.ops.wavefront as ref_wavefront
import bendy_tpu.utils.v3 as ref_v3
from bendy_tpu.render import Config as RefConfig
from bendy_tpu.render import Renderer as RefRenderer
from bendy_tpu.scene import load_scene as ref_load
from bendy_tpu.utils.rng import render_key as ref_key
from bendy_tpu_torch import Config, Renderer, _build, load_scene
from bendy_tpu_torch.ops.wavefront import trace_core
from bendy_tpu_torch.tools import dispatch_probe, phase_probe, prim_scaling
from bendy_tpu_torch.utils.rng import render_key
from torch_threads import one_intra_op_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

W = H = 16
SEED = 7
RTOL, ATOL = 5e-4, 1e-5
KERNEL = Path(__file__).resolve().parent.parent / "bendy_tpu_torch" / "csrc" / "trace_surface.cu"
CASES = ([("cornell", 4, phase) for phase in ("light", "shade", "sweep", "rng", "camera", "floor")]
         + [("volume", 1, phase) for phase in ("volume", "marchspec")])


@functools.cache
def _renderers(name):
    path = f"scenes/{name}.json.gz"
    ref_scene, port_scene = ref_load(path), load_scene(path)
    cam = ref_scene.find_by_tag("camera")
    for s in (ref_scene, port_scene):
        s.get_object(cam).inner.aspect_ratio = W / H
    ref = RefRenderer(ref_scene, RefConfig(max_bounces=3), use_pallas=False)
    port = Renderer(port_scene, Config(max_bounces=3), device="cpu")
    return ref, port, cam


@functools.cache
def _port_trace(name, spp, phase):
    _, r, cam = _renderers(name)
    cfg = r.trace_config(r.config, cam)
    with phase_probe.stubbed(phase):
        return trace_core(r.arrays, r.camera_params(cam), render_key(SEED, 0), torch.arange(W * H),
                          torch.zeros(W * H, dtype=torch.int64), W, H, spp, 1, cfg)


def _ref_trace(name, spp, phase):
    """The reference's trace_core, unjitted, with its own stubs of
    ``phase`` and 1/sqrt in place of its rsqrt."""
    from phase_probe import _stubs as ref_stubs

    r, _, cam = _renderers(name)
    cfg = r.trace_config(r.config, cam)
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        for module, attr, repl in ref_stubs()[phase]:
            mp.setattr(module, attr, repl)
        mp.setattr(ref_v3, "jax_rsqrt", lambda x: 1.0 / jnp.sqrt(x))
        return ref_wavefront.trace_core(
            r.arrays, r.camera_params(cam), ref_key(jnp.uint32(SEED), jnp.uint32(0)),
            jnp.arange(W * H, dtype=jnp.uint32), jnp.zeros(W * H, jnp.uint32), W, H, spp, 1,
            cfg)


@pytest.mark.parametrize("name,spp,phase", CASES, ids=[f"{n}-{p}" for n, _, p in CASES])
def test_stubbed_trace_matches_the_reference(name, spp, phase):
    port = _port_trace(name, spp, phase)
    ref = _ref_trace(name, spp, phase)
    for c in "xyz":
        np.testing.assert_allclose(getattr(port.radiance, c).numpy(),
                                   np.asarray(getattr(ref.radiance, c)), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {phase} radiance.{c}")
    assert int(port.rays) == int(ref.rays)
    # the stub took effect: the full loop traces another image
    full = _port_trace(name, spp, None)
    assert not torch.equal(port.radiance.x, full.radiance.x)


def test_stubs_bind():
    """Every (module, attr) the stubs patch exists and is callable (a
    rename in the plain modules would otherwise only surface on the card),
    and each phase's patches are its parts'."""
    tables = phase_probe.stubs()
    assert tuple(tables) == phase_probe.PHASES
    for phase, patches in tables.items():
        assert patches, phase
        for module, attr, repl in patches:
            assert callable(getattr(module, attr)), (phase, attr)
            assert callable(repl)
    attrs = {p: {a for _, a, _ in patches} for p, patches in tables.items()}
    assert attrs["marchspec"] == attrs["shade"] | attrs["light"]
    assert attrs["floor"] == attrs["shade"] | attrs["sweep"] | attrs["rng"] | attrs["camera"]
    assert attrs["sweep"] == {"nearest_hit", "nearest_hit_bvh_plain"}


def test_stubbed_restores_and_selects_the_stub_build(monkeypatch):
    """The tracer's launches, and they alone, take the stub build and its
    mask while a phase is stubbed (``_library`` stands in for the build:
    (block, stubs))."""
    import bendy_tpu_torch.ops.wavefront as wavefront

    monkeypatch.setattr(_build, "_library", lambda block, stubs=False: (block, stubs))
    orig = wavefront.nearest_hit
    with phase_probe.stubbed("floor"):
        assert wavefront.nearest_hit is phase_probe.stub_hit
        assert _build.PHASE_STUBS == phase_probe.stub_mask("floor") == 2 + 4 + 8 + 16
        assert _build.stub_flags() == 30 << _build.STUB_SHIFT
        assert _build.tracer() == ((128, True), 30 << _build.STUB_SHIFT)
        assert _build.library() == (128, False)
    assert wavefront.nearest_hit is orig and _build.PHASE_STUBS is None
    assert _build.stub_flags() == 0
    assert _build.tracer() == ((128, False), 0)
    with phase_probe.stubbed(None):
        assert _build.PHASE_STUBS == 0 and wavefront.nearest_hit is orig
    with pytest.raises(ValueError, match="6 bits"):
        with _build.phase_stubs(64):
            pass


def test_stub_masks_are_the_kernels():
    """The phase bits and the flags' shift are the kernel's, and every
    phase's mask, as the kernel instantiates it (the light inside the
    shade; no volume event without media), is one of STUB_MASKS."""
    src = KERNEL.read_text()
    bits = dict((k, int(v)) for k, v in re.findall(r"STUB_([A-Z]+) = (\d+)", src))
    assert {k.lower(): v for k, v in bits.items() if k != "SHIFT"} == phase_probe.STUB_BITS
    assert bits["SHIFT"] == _build.STUB_SHIFT
    masks_src = re.search(r"STUB_MASKS\[\] = \{([^}]*)\}", src).group(1)
    masks = {eval(re.sub(r"STUB_([A-Z]+)", lambda m: str(bits[m.group(1)]), e.strip()))
             for e in masks_src.split(",")}
    for phase in phase_probe.PHASES:
        mask = phase_probe.stub_mask(phase)
        if mask & bits["SHADE"]:
            mask &= ~bits["LIGHT"]
        for vol in (False, True):
            m = mask if vol else mask & ~bits["VOLUME"]
            assert m in masks, (phase, vol, m)


def test_stub_build_flags_sources_and_labels():
    flags = _build.nvcc_flags(128, stubs=True)
    assert "-DBENDY_PHASE_STUBS" in flags and "-DBENDY_PHASE_STUBS" not in _build.nvcc_flags(128)
    assert [p.name for p in _build.sources(stubs=True)] == ["trace_surface.cu"]
    assert len(_build.sources()) > 1
    assert _build.source_hash(stubs=True) != _build.source_hash()
    log = ("ptxas info    : Compiling entry function "
           "'_Z12trace_kernelILb0ELb0ELb1ELb0ELb0ELb0ELi30EEv6Params' for 'sm_90a'\n"
           "ptxas info    : Function properties for "
           "_Z12trace_kernelILb0ELb0ELb1ELb0ELb0ELb0ELi30EEv6Params\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 40 registers, used 0 barriers, 392 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function "
           "'_Z12trace_kernelILb0ELb0ELb0ELb0ELb0ELb1EEv6Params' for 'sm_90a'\n"
           "ptxas info    : Function properties for "
           "_Z12trace_kernelILb0ELb0ELb0ELb0ELb0ELb1EEv6Params\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 80 registers, used 1 barriers, 392 bytes cmem[0]\n")
    assert _build.ptxas_report(log) == [
        "trace_kernel<AOVS=0,GEO=0,VOL=1,LOOPM=0,GTAB=0,BVH=0,STUB=30> ITEM: 40 registers, "
        "0 B stack, 0/0 B spill st/ld",
        "trace_kernel<AOVS=0,GEO=0,VOL=0,LOOPM=0,GTAB=0,BVH=1>: 80 registers, "
        "0 B stack, 0/0 B spill st/ld"]


def test_phase_split_arithmetic():
    rows = {"full": {"us_per_warp_iter": 0.5}, "sweep": {"us_per_warp_iter": 0.3},
            "light": {"us_per_warp_iter": 0.55}, "floor": {"us_per_warp_iter": 0.125}}
    out = phase_probe.phase_split(rows)
    assert "phase_us" not in out["full"]
    assert out["sweep"]["phase_us"] == pytest.approx(0.2)
    assert out["sweep"]["phase_frac"] == pytest.approx(0.4)
    assert out["light"]["phase_us"] == pytest.approx(-0.05)  # a stub that runs slower
    assert out["floor"]["phase_frac"] == pytest.approx(0.75)
    assert out["floor"]["floor_residual_frac"] == pytest.approx(0.25)
    assert rows["sweep"] == {"us_per_warp_iter": 0.3}  # the input stays as it was


def test_default_phases_and_refusals():
    assert phase_probe.default_phases("cornell") == ["light", "shade", "sweep", "rng", "camera",
                                                     "floor"]
    assert phase_probe.default_phases("volume") == list(phase_probe.PHASES)
    assert phase_probe.check_phases(["floor", "light"]) == ["light", "floor"]
    with pytest.raises(ValueError, match="unknown phase"):
        phase_probe.check_phases(["light", "brick"])
    with pytest.raises(ValueError, match="unknown phase"):
        phase_probe.stub_mask("density_fetch_begin")
    with pytest.raises(ValueError, match="unknown phase"):
        with phase_probe.stubbed("walk"):
            pass
    with pytest.raises(ValueError, match="unknown phase"):
        phase_probe.main(["--phases", "light,brick"])


def test_march_share_reads_the_loops_counters():
    """On the CPU the march share comes from the plain loop's per-lane
    counters: volume events over rays, 0 without media."""
    share = phase_probe.march_share("volume", 8, 8, 2, device="cpu")
    assert 0.0 < share < 1.0
    assert phase_probe.march_share("cornell", 8, 8, 2, device="cpu") == 0.0


@pytest.mark.parametrize("main", [phase_probe.main, prim_scaling.main, dispatch_probe.main])
def test_tools_need_the_card(main):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the card-less refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        main([])


def test_tools_import_no_jax():
    code = ("import sys, bendy_tpu_torch.tools.phase_probe, bendy_tpu_torch.tools.prim_scaling, "
            "bendy_tpu_torch.tools.dispatch_probe; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'bendy_tpu.'))"
            " or m == 'bendy_tpu']; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
