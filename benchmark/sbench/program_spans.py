"""The program's own spans and counters in the traced window's
``torch.profiler`` trace (``seeksv_tpu_torch/utils/trace.py`` writes
them; a program without them leaves nothing here to read):

- the spans of the thread that runs the passes: ``user_annotation``
  events named ``seeksv.*``, on the trace's clock;
- for each pass the program recorded, the top-level key
  ``seeksv.pass.<id>``: its other threads' spans (the decode thread's
  ``seeksv.scan.decode``, the device finalize) in ``perf_counter``
  nanoseconds, its counters, and the nanoseconds read inside its
  annotations ``seeksv.clock.<id>.0`` and ``.1`` (the last of each name
  where one was opened again), which map those spans onto the trace's
  clock.

Every span is assigned to the ``bench.pass`` that contains its start.
Times are seconds on the trace's clock, as in ``sbench/trace.py``.
"""
from __future__ import annotations

import bisect
import json
import os

CLOCK = "seeksv.clock."
META = "seeksv.pass."
_CACHE = {}


class ProgramSpans:
    def __init__(self, path: str):
        with open(path) as f:
            doc = json.load(f)
        self.main = []      # (name, t0, t1): seeksv.* annotations
        self.passes = []    # (t0, t1) of bench.pass
        clocks = {}         # anchor name -> its last event's start
        for e in doc.get("traceEvents", []):
            if e.get("ph") != "X" or "dur" not in e \
                    or e.get("cat") != "user_annotation":
                continue
            name = e.get("name", "")
            t0 = float(e["ts"]) * 1e-6
            t1 = t0 + float(e["dur"]) * 1e-6
            if name.startswith(CLOCK):
                clocks[name] = max(t0, clocks.get(name, t0))
            elif name.startswith("seeksv."):
                self.main.append((name, t0, t1))
            elif name == "bench.pass":
                self.passes.append((t0, t1))
        self.main.sort(key=lambda s: (s[1], -s[2]))
        self.passes.sort()
        # per recorded pass: (start on the trace's clock, counts, its
        # worker spans), and all worker spans as (name, t0, t1,
        # parent_name) mapped onto the trace's clock
        self.records = []
        self.worker = []
        for k, rec in doc.items():
            if not k.startswith(META) or not isinstance(rec, dict):
                continue
            anchors = rec.get("anchor_ns", [])
            c = [clocks.get(f"{CLOCK}{rec.get('pass')}.{i}") for i in (0, 1)]
            if len(anchors) != 2 or None in c:
                continue
            to_s = clock_map(anchors[0], anchors[1], c[0], c[1])
            spans = [(s["name"], to_s(s["t0_ns"]), to_s(s["t1_ns"]),
                      s.get("parent_name")) for s in rec.get("spans", [])]
            self.records.append((c[0], rec.get("counts", {}), spans))
            self.worker += spans
        self.records.sort(key=lambda r: r[0])
        self.worker.sort(key=lambda s: s[1])

    def pass_of(self, t: float):
        """The index of the bench.pass that contains t, else None."""
        i = bisect.bisect_right(self.passes, (t, float("inf"))) - 1
        if i >= 0 and self.passes[i][0] <= t <= self.passes[i][1]:
            return i
        return None

    def per_pass(self) -> list:
        """For each bench.pass: {"main": [...], "worker": [...]}, the
        spans whose start it contains."""
        out = [{"main": [], "worker": []} for _ in self.passes]
        for key, spans in (("main", self.main), ("worker", self.worker)):
            for s in spans:
                i = self.pass_of(s[1])
                if i is not None:
                    out[i][key].append(s)
        return out


def clock_map(a0_ns: int, a1_ns: int, c0_s: float, c1_s: float):
    """perf_counter nanoseconds -> seconds on the trace's clock, through
    two anchors (a, c): a line, which also takes out any drift between
    the two clocks over a pass."""
    slope = (c1_s - c0_s) / (a1_ns - a0_ns) if a1_ns > a0_ns else 1e-9
    return lambda ns: c0_s + (ns - a0_ns) * slope


def load(ctx: dict):
    """The ProgramSpans of the run's trace (parsed once a file), or None
    where the run was not traced or the program recorded nothing."""
    path = ctx.get("trace_path")
    if not path or not os.path.exists(path):
        return None
    st = os.stat(path)
    key = (path, st.st_mtime_ns, st.st_size)
    if key not in _CACHE:
        _CACHE.clear()
        _CACHE[key] = ProgramSpans(path)
    ps = _CACHE[key]
    return ps if ps.main else None


def _inside(spans: list, outer: list) -> list:
    return [s for s in spans if any(o[1] <= s[1] <= o[2] for o in outer)]


def _mean(vals: list):
    return sum(vals) / len(vals) if vals else None


def scan_seconds(ctx: dict, names: tuple):
    """The mean over the window's passes of the seconds of the
    main-thread spans ``names`` inside the tumour's scan (the pass's
    ``seeksv.stage.scan_bam``); None where no pass has one."""
    ps = load(ctx)
    if ps is None:
        return None
    vals = []
    for p in ps.per_pass():
        stage = [s for s in p["main"] if s[0] == "seeksv.stage.scan_bam"]
        if stage:
            vals.append(sum(s[2] - s[1] for s in _inside(p["main"], stage)
                            if s[0] in names))
    return _mean(vals)


def decode_seconds(ctx: dict):
    """The mean over the window's passes of the decode thread's
    ``seeksv.scan.decode`` seconds in the tumour's scan (those opened
    under ``seeksv.stage.scan_bam``; the normal's are under
    ``seeksv.somatic.scan``); None where no pass recorded one."""
    ps = load(ctx)
    if ps is None:
        return None
    vals = []
    for p in ps.per_pass():
        dec = [s for s in p["worker"] if s[0] == "seeksv.scan.decode"
               and s[3] == "seeksv.stage.scan_bam"]
        if dec:
            vals.append(sum(s[2] - s[1] for s in dec))
    return _mean(vals)


def decode_mb_per_s(ctx: dict):
    """The mean over the window's recorded passes of the compressed BAM
    megabytes (1e6 bytes) that every scan of the pass decoded (the
    counter ``scan.bam_bytes``) over the decode thread's seconds in them
    (every ``seeksv.scan.decode``); None where no pass recorded both."""
    ps = load(ctx)
    if ps is None:
        return None
    vals = []
    for t0, counts, spans in ps.records:
        dec = sum(s[2] - s[1] for s in spans if s[0] == "seeksv.scan.decode")
        if ps.pass_of(t0) is not None and dec > 0 \
                and counts.get("scan.bam_bytes"):
            vals.append(counts["scan.bam_bytes"] * 1e-6 / dec)
    return _mean(vals)


def somatic_self_seconds(ctx: dict):
    """The mean over the window's passes of the somatic stage less the
    normal's scan nested in it (``seeksv.somatic.scan``); None where no
    pass ran one."""
    ps = load(ctx)
    if ps is None:
        return None
    vals = []
    for p in ps.per_pass():
        stage = [s for s in p["main"] if s[0] == "seeksv.stage.somatic"]
        if stage:
            scan = [s for s in _inside(p["main"], stage)
                    if s[0] == "seeksv.somatic.scan"]
            vals.append(sum(s[2] - s[1] for s in stage)
                        - sum(s[2] - s[1] for s in scan))
    return _mean(vals)
