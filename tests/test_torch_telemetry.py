"""The port's span recorder (``bendy_tpu_torch/telemetry.py``) on the CPU:
per-pass spans only while a profiler records and no profiler range per
span, their nesting and pass ids, the set-up spans once each."""

import pytest
import torch

from bendy_tpu_torch import telemetry
from bendy_tpu_torch.film import DeviceFilm
from bendy_tpu_torch.render import Config, Renderer, RenderConfig, Subsample
from bendy_tpu_torch.scene.io import load_scene

PER_PASS = {"render", "glue.trace", "glue.accumulate"}


def _cornell():
    scene = load_scene("scenes/cornell.json.gz")
    camera = scene.find_by_tag("camera")
    scene.get_object(camera).as_camera().aspect_ratio = 1.0
    return scene, camera


def _tiny(scene):
    return (Renderer(scene, Config(max_bounces=1), device="cpu"),
            DeviceFilm(4, 4, device="cpu"), RenderConfig(samples=1, subsample=Subsample(2)))


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()


@pytest.fixture(autouse=True)
def fresh():
    telemetry.clear()
    yield
    telemetry.clear()


def test_off_records_no_pass_span_and_opens_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    scene, camera = _cornell()
    r, film, rc = _tiny(scene)
    for _ in range(3):
        r.render(camera, rc, film)
    names = [s.name for s in telemetry.spans()]
    assert not PER_PASS & set(names) and "clock" not in names
    assert film.passes == 3 and not telemetry.ACTIVE


def test_on_records_each_pass_nested(monkeypatch):
    scene, camera = _cornell()
    r, film, rc = _tiny(scene)
    r.render(camera, rc, film)  # a pass before the profiler: not recorded
    opened = []
    orig = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return orig(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _profiled(lambda: [r.render(camera, rc, film) for _ in range(3)])
    r.render(camera, rc, film)  # after it: not recorded
    assert opened == ["bendy.clock"]  # the one anchor, no range per span
    spans = telemetry.spans()
    renders = [i for i, s in enumerate(spans) if s.name == "render"]
    assert [spans[i].pass_id for i in renders] == [1, 2, 3]
    assert [s.name for s in spans].count("clock") == 1
    for i in renders:
        r_span = spans[i]
        assert r_span.parent == -1 and r_span.start_ns < r_span.end_ns
        kids = [s for s in spans if s.parent == i]
        assert [s.name for s in kids] == ["glue.trace", "glue.accumulate"]
        for k in kids:
            assert k.pass_id == r_span.pass_id
            assert r_span.start_ns <= k.start_ns <= k.end_ns <= r_span.end_ns
        assert kids[0].end_ns <= kids[1].start_ns
    assert sum(s.name in PER_PASS for s in spans) == 9


def test_cache_hit_builds_nothing():
    scene, camera = _cornell()
    r, film, rc = _tiny(scene)
    r.render(camera, rc, film)
    assert [s.name for s in telemetry.spans()].count("pass.build") == 2  # pass, lanes
    first = len(telemetry.spans())
    _profiled(lambda: r.render(camera, rc, film))
    later = [s.name for s in telemetry.spans()[first:]]
    assert "pass.build" not in later and "render" in later
    # another shape misses the cache: a build inside the profiled render
    _profiled(lambda: r.render(camera, RenderConfig(samples=2, subsample=Subsample(2)), film))
    spans = telemetry.spans()
    builds = [s for s in spans if s.name == "pass.build"]
    assert len(builds) == 4 and spans[builds[-1].parent].name == "render"


def test_one_offs_once_per_scene():
    for k in (1, 2):
        scene, _ = _cornell()
        Renderer(scene, Config(max_bounces=1), device="cpu")
        names = [s.name for s in telemetry.spans()]
        assert names.count("scene.load") == names.count("scene.compile") == k
    assert all(s.parent == -1 and s.pass_id == -1 and s.end_ns >= s.start_ns
               for s in telemetry.spans())


def test_an_exception_closes_its_spans():
    outer = telemetry.start("render")
    telemetry.start("glue.trace")  # left open, as by an exception
    telemetry.stop(outer)
    a, b = telemetry.spans()
    assert a.end_ns == b.end_ns > 0 and b.parent == 0
    with pytest.raises(RuntimeError):
        with telemetry.one_off("pass.build"):
            raise RuntimeError("build failed")
    assert telemetry.spans()[-1].end_ns > 0 and telemetry.spans()[-1].parent == -1
