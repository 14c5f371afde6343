"""Spans and counters of the port, on the clock of the ``torch.profiler``
trace that the caller takes.

``span(name, into, key)`` always times its block with
``time.perf_counter_ns`` and, with ``into``, adds the seconds to
``into[key]``: the drivers' ``stages_s`` and ``BatchAligner.timings`` are
filled by the spans that trace them.  It records something only inside
a driver call (``driver_pass``) that began while a profiler was running
on the calling thread:

- a span opened on that thread (the "main" thread) also opens
  ``torch.profiler.record_function(name)``, so the trace holds it as a
  ``user_annotation`` event on the profiler's own clock, which its CUDA
  events share;
- a span opened on a worker thread (one that ran ``adopt(handoff())``;
  the profiler does not see threads other than the one that started it)
  and the pass's counters (``count``) are written into the same trace at
  the end of the call, as the top-level metadata key
  ``seeksv.pass.<pass id>``: a JSON object with ``pass``, ``thread`` (the
  main thread's native id), ``anchor_ns`` (the ``perf_counter_ns``
  values read inside the main-thread annotations ``seeksv.clock.<pass
  id>.0``, as the pass begins, and ``seeksv.clock.<pass id>.1``, as it
  ends; where one was opened more than once, the last one opened is the
  anchor), ``spans`` (the worker threads' spans: ``name``, ``thread``,
  ``t0_ns``, ``t1_ns``, ``id``, ``parent``, ``parent_name``) and
  ``counts``.  A reader maps a worker span onto the trace's clock
  through the two anchors.

With no profiler running nothing is recorded and nothing is opened: a
span costs two clock reads and one thread-local lookup.  Names are
``seeksv.<layer>.<what>``; spans mark stages and slabs, never records or
jobs.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Dict, List, Optional

CLOCK = "seeksv.clock"
META_PREFIX = "seeksv.pass."

_ids = itertools.count(1)
_tls = threading.local()
_last: List[Optional["Recording"]] = [None]


class Recording:
    """What one driver call recorded while a profiler ran."""

    def __init__(self):
        self.main = threading.get_ident()
        self.main_native = threading.get_native_id()
        self.pass_id = 0
        # (id, parent, name, native thread id, t0_ns, t1_ns)
        self.spans: List[tuple] = []
        self.counts: Dict[str, int] = {}
        self.anchor_ns: List[int] = []
        self.lock = threading.Lock()

    def names(self) -> Dict[int, str]:
        return {s[0]: s[2] for s in self.spans}

    def metadata(self) -> dict:
        names = self.names()
        return {"pass": self.pass_id, "thread": self.main_native,
                "anchor_ns": list(self.anchor_ns),
                "spans": [{"name": n, "thread": th, "t0_ns": t0,
                           "t1_ns": t1, "id": i, "parent": p,
                           "parent_name": names.get(p)}
                          for i, p, n, th, t0, t1 in self.spans
                          if th != self.main_native],
                "counts": dict(self.counts)}


def last() -> Optional[Recording]:
    """The newest finished recording of this process (None before the
    first driver call under a profiler)."""
    return _last[0]


class span:
    """Times its block; see the module's docstring."""

    __slots__ = ("name", "into", "key", "t0", "rec", "sid", "parent", "rf")

    def __init__(self, name: str, into: Optional[dict] = None,
                 key: Optional[str] = None):
        self.name, self.into, self.key = name, into, key

    def __enter__(self):
        self.rec = rec = getattr(_tls, "rec", None)
        if rec is not None:
            stack = _tls.stack
            self.sid = next(_ids)
            self.parent = stack[-1] if stack else _tls.base
            stack.append(self.sid)
            self.rf = None
            if threading.get_ident() == rec.main:
                from torch.profiler import record_function
                self.rf = record_function(self.name)
                self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.into is not None:
            self.into[self.key] = (self.into.get(self.key, 0.0)
                                   + (t1 - self.t0) * 1e-9)
        rec = self.rec
        if rec is not None:
            if self.rf is not None:
                self.rf.__exit__(None, None, None)
            _tls.stack.pop()
            rec.spans.append((self.sid, self.parent, self.name,
                              threading.get_native_id(), self.t0, t1))
        return False


def count(name: str, n: int = 1) -> None:
    """Add n to the pass's counter ``name`` (only while recording)."""
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        with rec.lock:
            rec.counts[name] = rec.counts.get(name, 0) + int(n)


def handoff():
    """What a worker thread started now passes to ``adopt`` so that its
    spans join this thread's recording, under the span open here; None
    while not recording.  The profiler flag is thread-local, so a worker
    cannot read it itself."""
    rec = getattr(_tls, "rec", None)
    if rec is None:
        return None
    stack = _tls.stack
    return rec, stack[-1] if stack else _tls.base


class adopt:
    """Record this (worker) thread's spans into the recording that
    ``handoff`` passed, until the block ends; a no-op for None."""

    __slots__ = ("token", "prev")

    def __init__(self, token):
        self.token = token

    def __enter__(self):
        if self.token is not None:
            self.prev = [getattr(_tls, k, None)
                         for k in ("rec", "stack", "base")]
            _tls.rec, _tls.base = self.token
            _tls.stack = []
        return self

    def __exit__(self, *exc):
        if self.token is not None:
            _tls.rec, _tls.stack, _tls.base = self.prev
        return False


def _anchor(rec: Recording) -> None:
    """Read perf_counter_ns as the annotation ``seeksv.clock.<pass>.<i>``
    opens.  Where the read lies more than 100 us after the open began
    (the thread was preempted), open it again, up to three times: the
    last one opened is the anchor."""
    from torch.profiler import record_function
    name = f"{CLOCK}.{rec.pass_id}.{len(rec.anchor_ns)}"
    for _ in range(3):
        t0 = time.perf_counter_ns()
        with record_function(name):
            t1 = time.perf_counter_ns()
        if t1 - t0 <= 100_000:
            break
    rec.anchor_ns.append(t1)


class driver_pass:
    """The root span of a driver call, ``seeksv.pass`` (its id is the
    pass id), timing into ``into[key]``.  It starts a recording when a
    profiler runs on this thread and none is open here yet (a driver
    called inside another's pass is a span of that pass), and writes
    the recording into the trace when it ends."""

    __slots__ = ("into", "key", "rec", "root")

    def __init__(self, into: Optional[dict] = None,
                 key: Optional[str] = None):
        self.into, self.key = into, key

    def __enter__(self):
        import torch
        self.rec = None
        if getattr(_tls, "rec", None) is None and \
                torch.autograd._profiler_enabled():
            self.rec = Recording()
            _tls.rec, _tls.stack, _tls.base = self.rec, [], 0
        self.root = span("seeksv.pass", self.into, self.key)
        self.root.__enter__()
        if self.rec is not None:
            self.rec.pass_id = self.root.sid
            _anchor(self.rec)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            _anchor(rec)
        self.root.__exit__(*exc)
        if rec is not None:
            try:
                import torch
                add = getattr(torch.autograd, "_add_metadata_json", None)
                if add is not None:
                    add(f"{META_PREFIX}{rec.pass_id}",
                        json.dumps(rec.metadata()))
            finally:
                _tls.rec = None
                _last[0] = rec
        return False
