"""The benchmark's readers of the program's spans
(``benchmark/program_spans.py``, ``benchmark/metrics/``): hand counts on a
synthetic trace whose program clock drifts against the trace's, the
placement of each pass inside its ``bench.render`` range, the gaps split by
the host's layer, nothing where there is nothing to read, and a profiled
render on the CPU mapped end to end."""

import sys

import pytest
import torch

from benchmark import program_spans, run, spec, trace
from bendy_tpu_torch import telemetry
from bendy_tpu_torch.telemetry import Span

DRIFT = 0.01  # the program's clock runs 1 % fast against the trace's
BASE_NS = 7_000_000_000  # and starts elsewhere
RANGES = [(1000.0 + 1000 * i, 1400.0 + 1000 * i) for i in range(3)]  # bench.render, us
GAPS = [(1100.0, 1150.0),  # pass 0, inside glue.trace
        (2020.0, 2050.0),  # pass 1, in render's self time before glue.trace
        (3450.0, 3500.0)]  # after pass 2's range: the host is in neither
WINDOW = (0.0, 4000.0)


def _ns(us):
    return int(BASE_NS + us * (1 + DRIFT) * 1e3)


def program(drop_render=False):
    """Set-up spans, then per pass: render [b0+5, b1-5], glue.trace
    [b0+50, b0+250], glue.accumulate [b0+260, b0+300] (true us)."""
    spans = [Span("scene.load", _ns(-900), _ns(-898), -1, -1),
             Span("scene.compile", _ns(-898), _ns(-895), -1, -1),
             Span("pass.build", _ns(-800), _ns(-770), 0, -1),
             Span("kernel.library", _ns(-790), _ns(-780), 0, 2),
             Span("pass.build", _ns(-700), _ns(-695), 0, -1),
             Span("clock", _ns(500), _ns(500), 0, -1)]
    for p, (b0, b1) in enumerate(RANGES):
        if drop_render and p == 1:
            continue
        i = len(spans)
        spans += [Span("render", _ns(b0 + 5), _ns(b1 - 5), p, -1),
                  Span("glue.trace", _ns(b0 + 50), _ns(b0 + 250), p, i),
                  Span("glue.accumulate", _ns(b0 + 260), _ns(b0 + 300), p, i)]
    return spans


def window():
    busy, t = [], WINDOW[0]
    for a, b in GAPS:
        busy.append(("void trace_kernel<false>(Params)", t, a, "kernel"))
        t = b
    busy.append(("accumulate_kernel", t, WINDOW[1], "kernel"))
    ranges = [("window", *WINDOW)] + [("render", a, b) for a, b in RANGES]
    ranges += [("sync", b, b + 100) for _, b in RANGES]
    return trace.Trace(busy, ranges, *WINDOW)


def readings(tr):
    return run.Readings(plan=None, setup_s=0.0, scene_setup_s=0.0, window=None, trace=tr,
                        refs=[], scene={})


def read(name, spans, tr=None, monkeypatch=None):
    monkeypatch.setattr(program_spans, "recorded", lambda: spans)
    return spec.reader(name)(readings(tr if tr is not None else window()))


def test_hand_counts(monkeypatch):
    spans = program()
    # self 150 us and glue 240 us a pass, on a clock 1 % fast
    assert read("front_end_self_ms", spans, monkeypatch=monkeypatch) == pytest.approx(
        0.150 * (1 + DRIFT), abs=1e-6)
    assert read("launch_glue_ms", spans, monkeypatch=monkeypatch) == pytest.approx(
        0.240 * (1 + DRIFT), abs=1e-6)
    # gap 0 (50 us) begins in glue, gap 1 (30 us) in self time, gap 2 in neither
    assert read("idle_in_launch_glue", spans, monkeypatch=monkeypatch) == pytest.approx(
        100 * 50 / 4000)
    assert read("idle_in_front_end", spans, monkeypatch=monkeypatch) == pytest.approx(
        100 * 30 / 4000)
    assert read("scene_compile_s", spans, monkeypatch=monkeypatch) == pytest.approx(
        5e-6 * (1 + DRIFT), rel=1e-3)
    # the library's load inside a pass build is counted once, with the build
    assert read("kernel_load_s", spans, monkeypatch=monkeypatch) == pytest.approx(
        35e-6 * (1 + DRIFT), rel=1e-3)
    # the split never exceeds what the breakdown puts under render
    tr = window()
    under_render = dict(tr.idle_by_span())["render (2 gaps)"]
    split = program_spans.idle_split(tr, spans)
    assert sum(split.values()) <= 100 * under_render / tr.window_s + 1e-9


def test_each_pass_maps_inside_its_range():
    m = program_spans.mapped(window(), program())
    assert len(m) == len(RANGES)
    for ((r0, r1), glue), (b0, b1) in zip(m, RANGES):
        assert b0 <= r0 < r1 <= b1
        assert all(r0 <= g0 < g1 <= r1 for g0, g1 in glue) and len(glue) == 2
    # one offset for the whole window would not do: the clocks drift 20 us
    # apart over two passes, and pass 0's offset puts pass 2 past its range
    renders = [s for s in program() if s.name == "render"]
    offset = m[0][0][0] - renders[0].start_ns / 1e3
    assert renders[-1].end_ns / 1e3 + offset > RANGES[-1][1]


@pytest.mark.parametrize("name", ["front_end_self_ms", "launch_glue_ms", "idle_in_front_end",
                                  "idle_in_launch_glue", "scene_compile_s", "kernel_load_s"])
@pytest.mark.parametrize("case", ["no spans", "no recorder", "counts differ"])
def test_nothing_to_read(monkeypatch, name, case):
    if case == "no recorder":  # a program without telemetry (an older checkout)
        import bendy_tpu_torch

        monkeypatch.delattr(bendy_tpu_torch, "telemetry")
        monkeypatch.setitem(sys.modules, "bendy_tpu_torch.telemetry", None)
        assert program_spans.recorded() is None
        assert spec.reader(name)(readings(window())) is None
        return
    spans = [] if case == "no spans" else program(drop_render=True)
    value = read(name, spans, monkeypatch=monkeypatch)
    if case == "no spans" or name.startswith("idle_in"):
        assert value is None
    else:  # host-clock readers need no mapping
        assert value is not None


def test_no_offset_no_mapping():
    tight = [("window", *WINDOW)] + [("render", a + 10, a + 20) for a, _ in RANGES]
    tr = trace.Trace(window().ops, tight, *WINDOW)
    assert program_spans.mapped(tr, program()) is None
    assert program_spans.idle_split(tr, program()) is None


def test_profiled_render_maps_inside_its_ranges():
    """On the CPU: renders inside bench.render ranges under the profiler,
    the exported trace read as the benchmark reads it, each program span
    placed inside its range."""
    from bendy_tpu_torch.film import DeviceFilm
    from bendy_tpu_torch.render import Config, Renderer, RenderConfig, Subsample
    from bendy_tpu_torch.scene.io import load_scene

    telemetry.clear()
    scene = load_scene("scenes/cornell.json.gz")
    camera = scene.find_by_tag("camera")
    scene.get_object(camera).as_camera().aspect_ratio = 1.0
    r = Renderer(scene, Config(max_bounces=1), device="cpu")
    film, rc = DeviceFilm(4, 4, device="cpu"), RenderConfig(samples=1, subsample=Subsample(2))
    r.render(camera, rc, film)
    rf = torch.profiler.record_function
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rf("bench.window"):
            for _ in range(3):
                with rf("bench.render"):
                    r.render(camera, rc, film)
    tr = trace.read(prof)
    spans = telemetry.spans()
    telemetry.clear()
    m = program_spans.mapped(tr, spans)
    ranges = sorted((s[1], s[2]) for s in tr.spans if s[0] == "render")
    assert m is not None and len(m) == len(ranges) == 3
    for ((r0, r1), glue), (b0, b1) in zip(m, ranges):
        assert b0 <= r0 < r1 <= b1 and len(glue) == 2
        assert all(r0 <= g0 <= g1 <= r1 for g0, g1 in glue)
    assert program_spans.idle_split(tr, spans) is not None
