"""The measured window: set-up, warm-up and the closed loop of one cell.

``measure`` runs one cell of the benchmark against the program and returns
what the window saw: the host clock's spans around each call into the
program, the passes whose film the check keeps, and, with ``trace``, the
profiler's events. It computes no metric and judges nothing.
"""

from __future__ import annotations

import collections
import contextlib
import time
from dataclasses import dataclass, field

import torch

from .traffic import Plan


@dataclass
class Kept:
    """A pass whose film the check keeps: the film's sums and the program's
    ray counter just before and just after it. In the window these are
    copies queued on the device behind the passes, so keeping a pass waits
    for nothing; they are read once the window has closed."""

    index: int
    seed: int
    before: torch.Tensor
    after: torch.Tensor
    rays_before: torch.Tensor
    rays_after: torch.Tensor

    @property
    def rays(self) -> int:
        """Rays the pass traced."""
        return int(self.rays_after) - int(self.rays_before)


@dataclass
class Window:
    passes: int = 0
    seconds: float = 0.0
    setup_end: float = 0.0  # host clock when set-up and warm-up had ended
    render_s: list = field(default_factory=list)
    kept: list = field(default_factory=list)
    profiler: object = None  # the exited torch.profiler.profile of a traced window


class Spans:
    """Host-clock spans around calls into the program; in a traced run each
    is also a profiler range named ``bench.<name>``, so the trace can say
    what the host was doing while the device idled."""

    def __init__(self, traced: bool) -> None:
        self.traced = traced

    def __call__(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _event(device: torch.device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def set_up(program, plan: Plan):
    """The film and the render settings, with the window's shape warmed up
    by two passes, then a synchronize."""
    program.set_aspect(plan.width / plan.height)
    film = program.film(plan.width, plan.height)
    rc = program.render_config(plan.spp, plan.subsample)
    for k in range(2):
        program.render(film, rc, plan.pass_seed(-1 - k))
    film.clear()
    program.ray_counter().tolist()  # waits for the warm-up passes
    return film, rc


def measure(program, plan: Plan, seconds: float, traced: bool) -> Window:
    film, rc = set_up(program, plan)
    win = Window(setup_end=time.perf_counter())
    dev = program.device
    span = Spans(traced)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    profiling = torch.profiler.profile(activities=acts) if traced else contextlib.nullcontext()
    with profiling as prof, span("window"):
        _chained(program, film, rc, plan, seconds, span, win)
    win.profiler = prof
    return win


def _chained(program, film, rc, plan, seconds, span, win) -> None:
    dev = program.device
    events = collections.deque()
    p = 0
    t0 = time.perf_counter()
    while True:
        if len(events) >= plan.inflight:
            with span("sync"):
                events.popleft().synchronize()
        keep = p in plan.kept
        if keep:
            before, rays_before = film.sum.clone(), program.ray_counter()
        ts = time.perf_counter()
        with span("render"):
            program.render(film, rc, plan.pass_seed(p))
        win.render_s.append(time.perf_counter() - ts)
        if keep:
            win.kept.append(Kept(p, plan.pass_seed(p), before, film.sum.clone(), rays_before,
                                 program.ray_counter()))
        ev = _event(dev)
        if ev is not None:
            events.append(ev)
        p += 1
        if time.perf_counter() - t0 >= seconds:
            break
    with span("sync"):
        _sync(dev)
    win.seconds = time.perf_counter() - t0
    win.passes = p
