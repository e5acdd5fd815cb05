"""The port's fidelity tool (``bendy_tpu_torch/tools/fidelity.py``) against
the reference's table (``docs/fidelity.json``, written by the reference's
``tools/fidelity.py``).

On the CPU the port's renders are the plain integrator's, which on flat
scenes renders the reference's lanes: cornell's entries equal the table's
to 7 digits. A scene with a medium diverges in a few lanes by float
order, so cloud is held to the statistical band.
"""

import glob
import importlib.util
import json
import math
import os

import pytest
import torch

from bendy_tpu_torch.tools import fidelity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLED = {os.path.basename(p)[: -len(".json.gz")] for p in glob.glob("scenes/*.json.gz")}


def _table(path):
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def test_scene_table_is_the_references():
    spec = importlib.util.spec_from_file_location(
        "fidelity_tool", os.path.join(ROOT, "tools", "fidelity.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert fidelity.FIDELITY_SCENES == ref.FIDELITY_SCENES
    assert set(fidelity.FIDELITY_SCENES) == BUNDLED


def test_defaults_are_the_references():
    args = fidelity.parser().parse_args([])
    assert (args.res, args.spot_res, args.spot_spp, args.spot_ref_spp, args.ref_spp,
            args.ref_spp_geodesic, args.spp, args.max_bounces) == (
                24, 48, 512, 2048, 8192, 2048, [16, 64, 256, 1024], 4)
    assert (args.device, args.out) == ("cuda", "docs/fidelity_torch.json")


def _curve(name, spps):
    """The scene's points at 24² through the port's CPU route."""
    scene, cam_ref, okw, _, _ = fidelity.prepare(name, 4)
    args = fidelity.parser().parse_args([])
    ref_spp = fidelity.FIDELITY_SCENES[name].get("ref_spp", args.ref_spp)
    return fidelity.points(scene, cam_ref, okw, 24, spps, ref_spp, False, device="cpu")


def test_cornell_meets_the_flat_band():
    entry = _curve("cornell", [16, 64])
    ref = _table("docs/fidelity.json")["cornell"]
    res = fidelity.check_against(entry, ref, "cornell")
    assert res["ok"], res["checks"]
    for point in ("16", "64"):
        assert entry[point]["mse"] == pytest.approx(ref[point]["mse"], rel=1e-5)
    # the band is tight: a 2 % change of one mse fails it
    entry["64"]["mse"] *= 1.02
    assert not fidelity.check_against(entry, ref, "cornell")["ok"]


def test_cloud_meets_the_statistical_band():
    entry = _curve("cloud", [16])
    ref = _table("docs/fidelity.json")["cloud"]
    res = fidelity.check_against(entry, ref, "cloud")
    assert res["ok"], res["checks"]
    assert entry["16"]["n_nonlight"] == 24 * 24
    # a bias shifted by four standard errors fails it
    se = math.sqrt(ref["16"]["mse_nonlight"] / entry["16"]["n_nonlight"])
    entry["16"]["bias_nonlight"] = ref["16"]["bias_nonlight"] + 4 * se
    assert not fidelity.check_against(entry, ref, "cloud")["ok"]


def test_check_against_needs_the_tables_points():
    ref = _table("docs/fidelity.json")["cornell"]
    entry = {"32": dict(ref["16"])}
    assert not fidelity.check_against(entry, ref, "cornell")["ok"]
    assert fidelity.check_against({"16": dict(ref["16"])}, ref, "cornell")["ok"]


def test_committed_table_meets_the_reference():
    """Every bundled scene has an entry in docs/fidelity_torch.json with
    every point of its docs/fidelity.json entry, each within its band; the
    run names its card and power limit (mirrors
    tests/test_scene.py:57-92)."""
    ours = _table("docs/fidelity_torch.json")
    ref = _table("docs/fidelity.json")
    assert BUNDLED <= set(ours), BUNDLED - set(ours)
    for name in BUNDLED:
        assert set(ours[name]) == set(ref[name]), name
        for point, v in ours[name].items():
            assert math.isfinite(v["mse"]), (name, point, v)
        res = fidelity.check_against(ours[name], ref[name], name)
        assert res["ok"], (name, [c for c in res["checks"] if c[4] > 1])
    meta = ours["_meta"]
    assert meta["device"].startswith("cuda") and "W" in meta["card"] and meta["commit"]


def test_main_needs_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        fidelity.main(["--scenes", "cornell", "--out", str(tmp_path / "f.json")])
    assert not (tmp_path / "f.json").exists()
