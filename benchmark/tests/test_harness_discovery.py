"""Every piece of the benchmark is found by name, and every cell builds its
traffic plan and its last line from fake readings. A later change adds a
cell, a configuration, a mix or a metric by adding files and entries."""

import dataclasses
import json
import math
import re
import time

import pytest
import torch

from benchmark import check, drive, run, spec, trace
from benchmark.program import Program
from benchmark.tests.cells import BENCH, CELLS, cell
from benchmark.traffic import plan

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (spec.ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        config = json.loads((spec.ROOT / c["file"]).read_text())
        # every cut is named in both places, with its reason in the file
        assert sorted(c["reduced"]) == sorted(config["reduced"])
        assert set(c["reduced"]) <= set(config["render"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", []):
            assert w in [c["name"] for c in BENCH["workloads"]]
    texts = [c["source"] for c in BENCH["configs"]] + [c["why"] for c in BENCH["configs"]]
    texts += [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]
    texts += BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.endswith("_torch")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_found_by_name(name):
    c = cell(name)
    assert c.scene_path().is_file()
    assert c.chips in (1, 4)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "mpaths_per_s"}
    assert c.per_layer
    for k in c.check["limits"]:
        assert k in ("film_off", "rays_off")


@pytest.mark.parametrize("name", CELLS)
def test_plan_is_drawn_from_the_seed(name):
    c = cell(name)
    a, b = plan(c.mix, 2**31 + 5), plan(c.mix, 2**31 + 5)
    assert a == b
    assert 0 in a.kept and len(a.kept) == 40
    assert plan(c.mix, 7).kept != a.kept
    assert a.paths_per_pass == c.mix["width"] * c.mix["height"] * c.mix["subsample"] ** 2 \
        * c.mix["spp"]


def fake_readings(c):
    p = plan(c.mix, 11)
    win = drive.Window(passes=40, seconds=10.0, setup_end=6.0)
    win.render_s = [3e-4] * 40
    d = p.paths_per_pass * 2e-4  # us of tracer a pass, ~3.4 ms for 16.8 M paths
    step = d * 1.2
    ops = [("void trace_kernel<true>(Params)", 1e6 + i * step, 1e6 + i * step + d, "kernel")
           for i in range(40)]
    ops += [("fold_kernel", 1e6 + i * step + d, 1e6 + i * step + 1.05 * d, "kernel")
            for i in range(40)]
    end = 1e6 + 41 * step
    spans = [("window", 1e6, end)] + [
        ("render", 1e6 + i * step, 1e6 + i * step + 300) for i in range(40)]
    tr = trace.Trace(ops, spans, 1e6, end)
    px = torch.arange(p.width * p.height)
    refs = [check.RefPass(px, torch.zeros(px.numel(), 3),
                          dict(rays=3 * p.paths_per_pass, near_steps=0, vol_events=0), True)]
    scene = dict(n_sph=0, n_rct=6, n_box=2, n_mass=0, floats=500)
    return run.Readings(p, 6.0, 0.5, win, tr, refs, scene)


@pytest.mark.parametrize("name", CELLS)
def test_last_line_from_fake_readings(name):
    c = cell(name)
    r = fake_readings(c)
    for traced, entries in ((False, c.end_to_end), (True, c.per_layer)):
        metrics = {}
        for m in entries:
            v = spec.reader(m["name"])(r)
            if "workloads" in m:  # listed cells always find something to read
                assert v is not None, m["name"]
            if v is not None:
                assert isinstance(v, float) and v >= 0 and math.isfinite(v), m["name"]
                if m["unit"] == "%":
                    assert v <= 100.0, m["name"]
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        line = json.dumps({"correct": True, "attempted": 40, "failed": 0, "metrics": metrics,
                           "device": {"platform": "gpu", "kind": "x", "count": 1,
                                      "memory_peak_bytes": 1}, "checks": {}})
        assert set(json.loads(line)) >= {"correct", "attempted", "failed", "metrics", "device"}
        assert metrics


def test_trace_busy_and_gaps():
    ops = [("k", 0.0, 10.0, "kernel"), ("k", 5.0, 20.0, "kernel"), ("m", 30.0, 40.0,
                                                                    "gpu_memcpy")]
    spans = [("window", 0.0, 50.0), ("render", 19.0, 25.0), ("sync", 40.0, 50.0)]
    t = trace.Trace(ops, spans, 0.0, 50.0)
    assert t.busy_s() == pytest.approx(30e-6)
    assert t.gaps() == [(20.0, 30.0), (40.0, 50.0)]
    labels = dict(t.idle_by_span())
    assert labels["render (1 gaps)"] == pytest.approx(10e-6)
    assert labels["sync (1 gaps)"] == pytest.approx(10e-6)
    assert t.kernel_s(("k",)) == pytest.approx(25e-6)


def test_every_file_is_named_from_a_name():
    for p in spec.HERE.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = str(p.relative_to(spec.ROOT))
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
            assert len(rel) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_on_the_cpu(name):
    """The traced path end to end: the profiler, the Chrome trace's spans,
    the breakdown and the host-clock readers (no device ops on the CPU)."""
    c = cell(name)
    c = dataclasses.replace(c, mix=dict(c.mix, width=16, height=12, spp=2))
    result, _ = run.run_cell(c, 5, 0.3, True, "cpu", time.perf_counter())
    assert result["correct"]
    assert result["device"]["window_s"] > 0 and set(result["breakdown"]) == {"device_ops",
                                                                             "idle_gaps"}
    assert result["metrics"]["render_host_ms.throughput"]["value"] > 0


def test_ray_counter_is_a_copy():
    """A kept pass's ray snapshot is a copy of the program's counter, so the
    passes after it cannot move it."""
    c = cell("cornell.batch")
    prog = Program(str(c.scene_path()), c.config["render"], "cpu")
    prog.set_aspect(1.0)
    film, rc = prog.film(4, 4), prog.render_config(1, 1)
    before = prog.ray_counter()
    prog.render(film, rc, 3)
    after = prog.ray_counter()
    prog.render(film, rc, 4)
    assert int(before) == 0 < int(after) < int(prog.ray_counter()) == prog.renderer.rays_traced
