"""The program's own spans, for the readers of a traced run.

The port records spans in memory (``bendy_tpu_torch.telemetry.spans()``, the
one piece of the program besides ``benchmark/program.py``'s API that the
benchmark reads): per-pass ones (``render``, and inside it ``glue.trace`` and
``glue.accumulate``) only while a profiler records, so in a ``--trace 1`` run
those of the window's passes; set-up ones (``scene.load``, ``scene.compile``,
``kernel.library``, ``pass.build``) always. A render's front-end self time is
its ``render`` span less its ``glue.*`` children.

The program stamps its spans with the host's ``perf_counter_ns``, not the
profiler's clock. The i-th ``render`` span lies inside the window's i-th
``bench.render`` range (``drive.Spans``), so each pass's spans are moved onto
the trace's clock by the midpoint of the offsets that nesting allows, from
bench_start - prog_start to bench_end - prog_end. Mapping pass by pass
absorbs any drift between the two clocks over a window.

Every function gives None where there is nothing to read: a program without
the recorder (an older checkout), no spans, counts of ``render`` spans and
ranges that differ, or a pass whose nesting leaves no offset.
"""

from __future__ import annotations

import bisect

NS_PER_US = 1e3


def recorded():
    """The program's spans (``telemetry.Span``: name, start_ns, end_ns,
    pass_id, parent), or None where the program records none."""
    try:
        from bendy_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry.spans()


def passes(spans) -> list:
    """[(render span, [its glue.* children]), ...] of the finished renders,
    in the order they ran."""
    out, at = [], {}
    for i, s in enumerate(spans or ()):
        if not s.end_ns:
            continue
        if s.name == "render":
            at[i] = len(out)
            out.append((s, []))
        elif s.name.startswith("glue.") and s.parent in at:
            out[at[s.parent]][1].append(s)
    return out


def _ns(s) -> int:
    return s.end_ns - s.start_ns


def host_ms(spans):
    """(front-end self ms, launch glue ms), each the mean over the recorded
    passes, or None without a pass."""
    ps = passes(spans)
    if not ps:
        return None
    glue = [sum(_ns(g) for g in gs) for _, gs in ps]
    self_ = [_ns(r) - g for (r, _), g in zip(ps, glue)]
    return sum(self_) / len(ps) / 1e6, sum(glue) / len(ps) / 1e6


def mapped(trace, spans):
    """[((render start, end), [(glue start, end), ...]), ...] in the trace's
    microseconds, pass by pass inside the window's ``bench.render`` ranges,
    or None."""
    ps = passes(spans)
    ranges = sorted((s for s in (trace.spans if trace is not None else ())
                     if s[0] == "render"), key=lambda s: s[1])
    if not ps or len(ps) != len(ranges):
        return None
    out = []
    for (r, gs), (_, b0, b1) in zip(ps, ranges):
        lo, hi = b0 - r.start_ns / NS_PER_US, b1 - r.end_ns / NS_PER_US
        if lo > hi:
            return None
        off = (lo + hi) / 2
        out.append(((r.start_ns / NS_PER_US + off, r.end_ns / NS_PER_US + off),
                    [(g.start_ns / NS_PER_US + off, g.end_ns / NS_PER_US + off) for g in gs]))
    return out


def idle_split(trace, spans):
    """{"front end": %, "launch glue": %}: the shares of the traced window
    spent in idle gaps (``Trace.gaps()``) that begin while the host is in a
    ``render`` span's self time, or in one of its ``glue.*`` children; None
    where the spans do not map."""
    m = mapped(trace, spans)
    if m is None or trace.window_s <= 0:
        return None
    starts = [r[0] for r, _ in m]
    tot = {"front end": 0.0, "launch glue": 0.0}
    for a, b in trace.gaps():
        j = bisect.bisect_right(starts, a) - 1
        if j < 0 or not m[j][0][0] <= a < m[j][0][1]:
            continue
        in_glue = any(g0 <= a < g1 for g0, g1 in m[j][1])
        tot["launch glue" if in_glue else "front end"] += b - a
    window_us = trace.end_us - trace.start_us
    return {k: 100.0 * v / window_us for k, v in tot.items()}


def one_off_s(spans, names) -> float | None:
    """Seconds of the spans named in ``names``, each counted once (a span
    inside another of them is not added again); None where there is none."""
    names = set(names)
    total, found = 0, False
    for s in spans or ():
        if s.name not in names or not s.end_ns:
            continue
        found = True
        p = s.parent
        while p >= 0 and spans[p].name not in names:
            p = spans[p].parent
        if p < 0:
            total += _ns(s)
    return total / 1e9 if found else None
