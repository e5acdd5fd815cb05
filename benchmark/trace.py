"""Reading the profiler's trace of the window.

The profiler (CPU and CUDA activities) is exported as a Chrome trace, in
which device operations (kernels, copies, sets) and the benchmark's own
``bench.<name>`` ranges share one clock. From it: the device operations in
the window, the seconds in which one ran (``busy_s``), and the gaps in
which none ran, each labelled by the benchmark span the host was in.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
US = 1e-6


@dataclass
class Trace:
    ops: list  # (name, start_us, end_us, cat) of every device operation in the window
    spans: list  # (name, start_us, end_us) of the benchmark's host spans
    start_us: float
    end_us: float

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * US

    def kernels(self) -> list:
        return [o for o in self.ops if o[3] == "kernel"]

    def kernel_s(self, parts) -> float:
        """Seconds of the kernels whose names hold any of ``parts``."""
        return sum(b - a for name, a, b, _ in self.kernels()
                   if any(k in name for k in parts)) * US

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end) pairs."""
        out = []
        for _, a, b, _ in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.start_us), min(b, self.end_us)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * US

    def gaps(self) -> list:
        """(start_us, end_us) of each stretch of the window with no device
        operation."""
        out, t = [], self.start_us
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end_us > t:
            out.append((t, self.end_us))
        return out

    def idle_by_span(self) -> list:
        """[[label, seconds], ...]: the window's idle time summed by what the
        host was doing when each gap began, longest first."""
        spans = sorted((s for s in self.spans if s[0] != "window"), key=lambda s: s[1])
        starts = [s[1] for s in spans]
        tot, cnt = defaultdict(float), defaultdict(int)
        for a, b in self.gaps():
            i = bisect.bisect_right(starts, a)
            label = "between spans"
            for j in range(i - 1, max(i - 64, -1), -1):  # spans open at a, innermost last
                name, s0, s1 = spans[j]
                if s0 <= a < s1:
                    label = name
                    break
            tot[label] += (b - a) * US
            cnt[label] += 1
        return sorted(([f"{k} ({cnt[k]} gaps)", v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])

    def ops_by_name(self) -> list:
        """[[name, seconds], ...] of device operations, longest first."""
        tot = defaultdict(float)
        for name, a, b, _ in self.ops:
            tot[name] += (min(b, self.end_us) - max(a, self.start_us)) * US
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])


def read(prof) -> Trace:
    """The window's trace from an exited ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops.append((e.get("name", "?"), ts, ts + dur, cat))
        elif cat == "user_annotation" and e.get("name", "").startswith("bench."):
            spans.append((e["name"][len("bench."):], ts, ts + dur))
    windows = [s for s in spans if s[0] == "window"]
    if not windows:
        raise RuntimeError("the trace holds no bench.window range")
    _, start, end = windows[0]
    ops = [o for o in ops if o[2] > start and o[1] < end]
    return Trace(ops, spans, start, end)
