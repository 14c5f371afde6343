"""Reading a ``torch.profiler`` trace of the measured window.

The benchmark's own spans (``bench.<layer>``, ``bench.pass``,
``bench.window``) come from ``torch.profiler.record_function`` around
the calls into each layer; the device's activity (kernels, copies,
memsets) from the profiler's CUDA events.  Times are seconds.
"""
from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.spans = []     # (name, start, end) of the bench.* host spans
        self.device = []    # (name, start, end) of device activity
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0 = float(e["ts"]) * 1e-6
            t1 = t0 + float(e["dur"]) * 1e-6
            cat = e.get("cat", "")
            if cat == "user_annotation" and e["name"].startswith("bench."):
                self.spans.append((e["name"], t0, t1))
            elif cat in DEVICE_CATS:
                self.device.append((e["name"], t0, t1))
        self.device.sort(key=lambda x: x[1])
        win = [s for s in self.spans if s[0] == "bench.window"]
        if not win:
            raise ValueError("the trace holds no bench.window span")
        self.w0, self.w1 = win[0][1], win[0][2]

    def passes(self) -> list:
        return sorted((s for s in self.spans if s[0] == "bench.pass"),
                      key=lambda s: s[1])

    def busy(self, t0=None, t1=None) -> list:
        """Merged intervals in which something ran on the device."""
        t0 = self.w0 if t0 is None else t0
        t1 = self.w1 if t1 is None else t1
        out = []
        for _n, a, b in self.device:
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def window_s(self) -> float:
        return self.w1 - self.w0

    def device_s(self, substr: str, t0: float, t1: float) -> float:
        """Device seconds of the events whose name holds substr and that
        start inside [t0, t1]."""
        return sum(b - a for n, a, b in self.device
                   if substr in n and t0 <= a <= t1)

    def top_ops(self, n: int = 10) -> list:
        tot = {}
        for name, a, b in self.device:
            if self.w0 <= a <= self.w1:
                k = short_name(name)
                tot[k] = tot.get(k, 0.0) + (b - a)
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda x: -x[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time in the window, split over the bench.*
        layer spans open on the host meanwhile (the rest: inside a pass
        outside the layers' spans, or between passes)."""
        gaps, cur = [], self.w0
        for a, b in self.busy():
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if self.w1 > cur:
            gaps.append((cur, self.w1))
        layers = sorted((s for s in self.spans
                         if s[0] not in ("bench.window", "bench.pass")),
                        key=lambda s: s[1])
        passes = self.passes()
        tot = {}

        def add(name, x):
            if x > 0:
                tot[name] = tot.get(name, 0.0) + x
        for a, b in gaps:
            covered = 0.0
            for name, s0, s1 in layers:
                x = min(b, s1) - max(a, s0)
                add(name, x)
                covered += max(x, 0.0)
            in_pass = sum(max(0.0, min(b, p1) - max(a, p0))
                          for _n, p0, p1 in passes)
            add("bench.pass (outside the layers' spans)", in_pass - covered)
            add("bench.window (between passes)", (b - a) - in_pass)
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda x: -x[1])[:n]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and
    parameters."""
    name = name.replace("void ", "", 1).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name.strip()[:200]
