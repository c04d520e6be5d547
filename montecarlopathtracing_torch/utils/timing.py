"""The program's tracer, and a profiler trace context.

``span(name)`` marks a piece of the program's host work: the frame driver,
the lane pool and its blocks, the gradient's two passes, the scene load.
Tracing is off by default, and then ``span`` is one test of a module flag
that returns a shared no-op context: no clock read, no allocation, nothing
on the device.  Inside ``tracing()`` every span is kept in memory, with its
start and end on ``time.monotonic_ns()``, its own id, its parent's (the
span open when it opened), the request it belongs to (a frame's or a
gradient step's ``RenderOptions.seed``), and the counts given at its
boundaries.  ``Trace.unix_ns`` puts a span's times on the Unix-epoch clock
of ``torch.profiler``'s events, so a span and the device's activity can be
laid on one timeline.

The program's counters (``integrator.wavefront.loop_stats()`` and its
siblings, the kernel wrappers' ``launches``) stay where they are; the
capture spans and ``capture_s`` are taken from the same two clock readings.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import List, Optional

import torch

from .logging import get_logger

log = get_logger(__name__)


class Trace:
    """The spans of one ``tracing()`` block, in the order they closed: dicts
    of ``name``, ``start_ns``, ``end_ns`` (``time.monotonic_ns()``), ``id``,
    ``parent`` (None at the top), ``request`` and ``counts``."""

    def __init__(self):
        # The Unix-epoch clock less the monotonic one, read once.
        self.offset_ns = time.time_ns() - time.monotonic_ns()
        self.spans: List[dict] = []
        self._open: List["_Span"] = []
        self._ids = itertools.count(1)

    def unix_ns(self, t_ns: int) -> int:
        """A span's time on the clock of torch.profiler's events."""
        return t_ns + self.offset_ns

    def _close(self, sp: "_Span", end_ns: int) -> None:
        # Spans a raising block left open below this one close with it.
        while self._open and self._open.pop() is not sp:
            pass
        self.spans.append({"name": sp.name, "start_ns": sp.start_ns,
                           "end_ns": end_ns, "id": sp.id, "parent": sp.parent,
                           "request": sp.request, "counts": sp.counts})


class _Span:
    __slots__ = ("trace", "name", "counts", "request", "id", "parent", "start_ns")

    def __init__(self, trace: Trace, name: str, counts, request):
        self.trace, self.name = trace, name
        self.counts = dict(counts) if counts else {}
        self.request = request

    def __enter__(self):
        return self.open(None)

    def open(self, start_ns: Optional[int]):
        tr = self.trace
        top = tr._open[-1] if tr._open else None
        self.id = next(tr._ids)
        self.parent = top.id if top is not None else None
        if self.request is None and top is not None:
            self.request = top.request
        tr._open.append(self)
        self.start_ns = time.monotonic_ns() if start_ns is None else start_ns
        return self

    def __exit__(self, *exc):
        self.trace._close(self, time.monotonic_ns())
        return False

    def note(self, **counts) -> None:
        """Counts known only at the span's end."""
        self.counts.update(counts)


class _Off:
    """The span handed out while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **counts) -> None:
        pass


_OFF = _Off()
_trace: Optional[Trace] = None


def span(name: str, counts: Optional[dict] = None, request=None):
    """A context that records the block as a span named ``name`` while
    tracing is on, with ``counts`` (a dict) taken at its start; ``request``
    defaults to the enclosing span's."""
    if _trace is None:
        return _OFF
    return _Span(_trace, name, counts, request)


def record(name: str, start_ns: int, end_ns: int,
           counts: Optional[dict] = None) -> None:
    """A span whose two clock readings (``time.monotonic_ns()``) the caller
    took itself, recorded as a child of the open span; nothing when
    tracing is off."""
    tr = _trace
    if tr is None:
        return
    tr._close(_Span(tr, name, counts, None).open(start_ns), end_ns)


@contextlib.contextmanager
def tracing():
    """Turns tracing on for the block; yields its Trace.  A nested block
    keeps its own spans, and the outer one's resume after it."""
    global _trace
    before, _trace = _trace, Trace()
    try:
        yield _trace
    finally:
        _trace = before


def chrome_events(trace: Trace, base_ns: int, pid: int) -> List[dict]:
    """The spans as Chrome-trace complete events (``"ph": "X"``, times in
    microseconds after ``base_ns`` on the Unix-epoch clock) on a thread of
    their own, ``program spans``."""
    tid = 0
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": "program spans"}}]
    for s in sorted(trace.spans, key=lambda s: (s["start_ns"], -s["end_ns"])):
        out.append({
            "ph": "X", "cat": "program", "name": s["name"], "pid": pid,
            "tid": tid, "ts": (trace.unix_ns(s["start_ns"]) - base_ns) / 1e3,
            "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
            "args": {"id": s["id"], "parent": s["parent"],
                     "request": s["request"], **s["counts"]}})
    return out


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """torch.profiler trace of the block, CPU and (when there is a card)
    CUDA activity, with the program's spans on a thread of their own above
    it, written to ``logdir`` as a Chrome trace (``trace.json``, view in
    chrome://tracing or Perfetto).  Counterpart of the JAX package's
    jax.profiler trace context."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tracing() as tr, profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    # Newer profilers write event times relative to this base.
    doc["traceEvents"] += chrome_events(
        tr, int(doc.get("baseTimeNanoseconds", 0)), os.getpid())
    with open(path, "w") as fh:
        json.dump(doc, fh)
    log.info("profiler trace written to %s", path)
