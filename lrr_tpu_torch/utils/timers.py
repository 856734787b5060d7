"""Stage timing and the program's trace (lrr_tpu/utils/timers.py).

`StageTimers` is the reference's wall-clock instrumentation (vul_timer
PROGRESS_OUTPUT/TIMER_OUTPUT macros, itk::TimeProbe around every extraction
stage): named stages, each ended by a synchronise, which `cli batch` writes
into its report.

The trace is the program's own record of where its host time goes: spans
opened at the layers' boundaries (`span`) and counters (`count`), kept in
one bounded buffer of the process and handed over by `drain`.  It is off
until `trace_on`; off, a span is one flag check that returns a shared no-op
context.  On, a span reads `time.perf_counter_ns()` at its start and end and
never synchronises or records a CUDA event, so spans are legal inside a CUDA
graph's warm-up and capture under the sync debug mode "error".  With an
`annotate` prefix each span also opens `torch.profiler.record_function(
annotate + name)`, so that a profiler that runs meanwhile holds the spans on
its own clock, beside the device's kernels.  Spans nest on the host thread
that opens them (the program's host code is one thread): each records its
parent, and its request, the id `request` gave the scope it was opened in,
else its root span's id.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from collections import defaultdict
from typing import Dict, NamedTuple

import torch


class StageTimers:
    """Accumulating named timers.  With `sync`, a timed stage starts and
    ends in `torch.cuda.synchronize()` once a CUDA context exists, so work
    queued on the card counts for the stage that queued it."""

    def __init__(self, sync: bool = True):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync = sync

    def _sync(self):
        if self.sync and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def time(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name:32s} {self.totals[name]:9.3f}s  x{self.counts[name]}"
            )
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k]}
            for k in self.totals
        }


class Span(NamedTuple):
    """A closed span.  Ids count from 1 in a process; `parent` is 0 for a
    root span; times are `time.perf_counter_ns()`."""

    name: str
    id: int
    parent: int
    request: object  # the id `request` gave the scope, else the root span's id
    start_ns: int
    end_ns: int
    attrs: dict


class Drained(NamedTuple):
    """What `drain` hands over: the spans closed since the last drain (in
    the order they closed), the counters' sums, and the spans the full
    buffer turned away."""

    spans: list
    counters: dict
    dropped: int


# closed spans kept between two drains; later ones are counted as dropped
SPAN_CAPACITY = 1 << 16


class _Trace:
    """The process's trace: whether it is on, the annotation prefix, the
    open spans (innermost last), the current request scope, and the closed
    spans and counters not yet drained."""

    def __init__(self):
        self.on = False
        self.annotate: str | None = None
        self.open: list = []
        self.request = None
        self.ids = itertools.count(1)
        self.spans: list = []
        self.counters: dict = {}
        self.dropped = 0


_TRACE = _Trace()
_OFF = contextlib.nullcontext()  # every span and request scope while the trace is off


class _OpenSpan:
    __slots__ = ("name", "attrs", "id", "parent", "request", "start", "annotation")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        t = _TRACE
        outer = t.open[-1] if t.open else None
        self.id = next(t.ids)
        self.parent = outer.id if outer is not None else 0
        if t.request is not None:
            self.request = t.request
        else:
            self.request = outer.request if outer is not None else self.id
        t.open.append(self)
        self.annotation = None
        if t.annotate is not None:
            self.annotation = torch.profiler.record_function(t.annotate + self.name)
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        t = _TRACE
        t.open.pop()
        if len(t.spans) < SPAN_CAPACITY:
            t.spans.append(Span(self.name, self.id, self.parent, self.request, self.start, end,
                                self.attrs))
        else:
            t.dropped += 1
        return False


class _Request:
    __slots__ = ("rid", "outer")

    def __init__(self, rid):
        self.rid = rid

    def __enter__(self):
        self.outer, _TRACE.request = _TRACE.request, self.rid
        return self

    def __exit__(self, *exc):
        _TRACE.request = self.outer
        return False


def trace_on(annotate: str | None = None) -> None:
    """Start recording spans and counters.  With `annotate`, each span is
    also a profiler range named `annotate + name`."""
    _TRACE.on, _TRACE.annotate = True, annotate


def trace_off() -> None:
    """Stop recording (what was recorded stays until `drain`)."""
    _TRACE.on, _TRACE.annotate = False, None


def enabled() -> bool:
    """Whether the trace is on: for a counter whose value costs work."""
    return _TRACE.on


def span(name: str, **attrs):
    """A context that records one span named `name` with small int or str
    attributes; the shared no-op context while the trace is off."""
    if not _TRACE.on:
        return _OFF
    return _OpenSpan(name, attrs)


def request(rid):
    """A scope whose spans carry the request id `rid`."""
    if not _TRACE.on:
        return _OFF
    return _Request(rid)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` (nothing while the trace is off)."""
    if _TRACE.on:
        _TRACE.counters[name] = _TRACE.counters.get(name, 0) + n


def drain() -> Drained:
    """The spans closed and the counters added since the last drain; the
    buffer is empty afterwards."""
    t = _TRACE
    out = Drained(t.spans, t.counters, t.dropped)
    t.spans, t.counters, t.dropped = [], {}, 0
    return out
