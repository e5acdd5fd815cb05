"""The port's span recorder: where the host's time goes in set-up and in a pass.

Spans are kept in memory, stamped with one host clock
(``time.perf_counter_ns``). Each holds its name, start and end, the pass it
belongs to (``film.passes`` at :meth:`Renderer.render`'s entry; -1 outside a
render) and the index of its parent span (-1 for none).

Per-pass spans are recorded only while a ``torch.profiler`` records:
``Renderer.render`` asks once a call (:func:`begin_render`) and each site
inside the pass tests :data:`ACTIVE`, so with no profiler a pass pays for that
check and a branch a site. A ``glue.*`` span is recorded as it closes
(:func:`span`), one call, so a set-up span inside one has the ``render`` as
its parent. No span opens a profiler range of its own.

=================== ====================================================
span                where
=================== ====================================================
``render``          ``Renderer.render``, the whole call (per pass)
``glue.trace``      the render pass's tracer call: every launch and fold
``glue.accumulate`` the render pass's ``accumulate`` call
``scene.load``      ``scene.io.load_scene`` (always)
``scene.compile``   ``Renderer.__init__``: the scene compile, its host copy
                    and the material facts (always)
``kernel.library``  the kernel library's load: the source hash, an nvcc
                    build where none exists, the ``CDLL`` and its
                    signatures (always)
``pass.build``      a pass's first build: the render pass, the tracer's
                    table (and BVH), a row chunk's lanes (always)
``clock``           the clock anchor (below)
=================== ====================================================

A render's front-end self time is its ``render`` span less its ``glue.*``
children.

Counters, like the per-pass spans, are kept only while a profiler records:
a profiled ``Renderer.render`` hands its pass the renderer's device [3]
int64 tally (:func:`tally`). Every tracer launch adds its own warp use to
its first two words at its end (one count on every path, ``count_warp_use``
in ``csrc/trace_surface.cu``; the CPU route adds ``ops/trace_kernel.warp_use``
of its lanes' iterations), and the tracer's call adds its lanes' volume
events to the third (``ops/trace_kernel.add_vol_events``, one ``sum`` of
the per-lane counts the tracer returns; nothing without media).
:func:`counters` sums the tallies:

======================= ================================================
counter                 what the profiled passes added
======================= ================================================
``loop_thread_iters``   the tracer's thread-loop iterations, over its
                        threads (one a lane, one a (lane, sample) item,
                        or LOOPM's: the items a thread took, summed)
``loop_issued_iters``   the iterations the warps of 32 consecutive
                        threads issue: 32 × each warp's longest loop
``vol_events``          the tracer's volume events (density lookups),
                        over its lanes; 0 in a scene without media
======================= ================================================

The first two leave out a launch's trailing partial warp, as
``ops/trace_kernel.warp_use`` does; their ratio is the share of the warps'
issued loop iterations that a thread used.

The clock anchor: at the first render of a profiling session (the first that
finds a profiler recording after one that did not), the recorder opens one
profiler range, ``bendy.clock``, stamps its clock inside it, and records that
stamp as a ``clock`` span. A reader of the profiler's Chrome trace places the
recorder's spans on the trace's clock by the range's middle: the stamp lies
somewhere in the range, so the error is at most half its length (tens of
microseconds on an H100 machine; the first range of a process takes longer).

Readers use :func:`spans`, :func:`counters`, and :func:`clear` to start a
fresh record (tests, and the CLI as it starts its profiler); the rest is the
program's.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

now = time.perf_counter_ns  # the recorder's clock
_profiler_enabled = torch._C._autograd._profiler_enabled

# span i is _names[i] and _ints[4i:4i+4]: start_ns, end_ns (0 while open), pass,
# parent. Flat ints, which the garbage collector does not track: a list a span
# made its collections cost about 15 us a pass over a 20 s window of 1 spp
# passes (the host of an H100 machine).
_names: list = []
_ints: list = []
_open: list = []  # indices of the open spans, innermost last
_pass = -1  # the pass of the render under way
_profiling = False  # whether the last render found a profiler recording
_tallies: list = []  # the device [3] int64 tallies that profiled passes counted into
COUNTERS = ("loop_thread_iters", "loop_issued_iters", "vol_events")  # a tally's words

ACTIVE = False  # per-pass spans are recorded in the render under way


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int  # 0 while the span is open
    pass_id: int
    parent: int  # index in spans() of the enclosing span, -1 for none


def spans() -> list[Span]:
    """Every span recorded so far, in the order they were opened (a per-pass
    span inside the render, in the order it closed)."""
    v = _ints
    return [Span(n, v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3])
            for i, n in enumerate(_names)]


def counters() -> dict:
    """The counters (table above), summed over every tally that profiled
    passes counted into since :func:`clear`; reading them waits for those
    passes. Zero where no profiled pass ran."""
    total = [0] * len(COUNTERS)
    for counts in _tallies:
        total = [a + b for a, b in zip(total, counts.tolist())]
    return dict(zip(COUNTERS, total))


def clear() -> None:
    """Forget every span, zero the counters, and start a fresh record."""
    global ACTIVE, _pass, _profiling
    for counts in _tallies:
        counts.zero_()
    for a in (_names, _ints, _open, _tallies):
        del a[:]
    ACTIVE, _pass, _profiling = False, -1, False


def tally(counts: torch.Tensor) -> torch.Tensor:
    """At a profiled render (:data:`ACTIVE`): ``counts``, the renderer's
    device [3] int64 counter (:data:`COUNTERS`) that its pass adds to, kept
    for :func:`counters`."""
    if not any(counts is t for t in _tallies):
        _tallies.append(counts)
    return counts


def _record(name: str, t0: int, t1: int) -> int:
    i = len(_names)
    _names.append(name)
    _ints.extend((t0, t1, _pass, _open[-1] if _open else -1))
    return i


def start(name: str) -> int:
    """Open span ``name`` inside the innermost open one; its index."""
    i = _record(name, now(), 0)
    _open.append(i)
    return i


def stop(i: int) -> None:
    """Close span ``i``, and any span still open inside it (left so by an
    exception), at one stamp."""
    t = now()
    j = _open.pop()
    _ints[4 * j + 1] = t
    while j != i:
        j = _open.pop()
        _ints[4 * j + 1] = t


def span(name: str, t0: int) -> None:
    """Record a per-pass span that began at ``t0`` (:func:`now`) and ends
    now, inside the innermost open span: one call a span, at its close."""
    _record(name, t0, now())


@contextlib.contextmanager
def one_off(name: str):
    """A set-up span, recorded whether or not a profiler records."""
    i = start(name)
    try:
        yield
    finally:
        stop(i)


def begin_render(pass_id: int) -> int:
    """At ``Renderer.render``'s entry: check once whether a profiler records
    and set :data:`ACTIVE`; open the ``render`` span if one does (anchoring
    the clock at a session's first render). Returns the span's index, or -1
    when nothing is recorded."""
    global ACTIVE, _pass, _profiling
    _pass = pass_id
    on = _profiler_enabled()
    if on and not _profiling:
        _anchor()
    _profiling = ACTIVE = on
    return start("render") if on else -1


def end_render(i: int) -> None:
    """At ``Renderer.render``'s exit: close span ``i`` (from
    :func:`begin_render`) and stop recording per-pass spans."""
    global ACTIVE, _pass
    if i >= 0:
        stop(i)
    ACTIVE, _pass = False, -1


def _anchor() -> None:
    with torch.profiler.record_function("bendy.clock"):
        t = now()
    _record("clock", t, t)
