"""Structured, rate-limited logging, and the port's one span primitive.

Diagnostics are opt-in, structured, and rate-limited so they can stay
enabled in production without perturbing the pipeline.

``Timer`` is a span.  It always adds its host duration to
``Timer.registry`` (the last ``REGISTRY_LEN`` per name).  Inside
``tracing()`` it also appends one record to the trace: name, call id
(the id of the outermost span open, one per ``verify_batch`` call), its
own id and its parent's, ``start_ns``/``end_ns`` from ``time.time_ns()``
(the clock of ``torch.profiler``'s events, so spans line up with the
card's kernels), and small integer ``attrs``.  While a ``torch.profiler``
session records, it also opens a ``record_function`` of its name, so the
profiler trace carries the program's spans.  Around asynchronous device
work a span measures until the next point where the host waits for the
device (a download); ``marks_for`` adds CUDA events while tracing.

    from echoseal_torch.utils.logging import Timer, get_logger, tracing
    log = get_logger("rx")
    log.event("peak", band=2, idx=14580, corr=0.91)   # <= rate-limited
    with Timer("scan", rows=8) as t: ...
    with tracing() as tr:
        verifier.verify_batch(clips, n_valid)
    spans = tr.drain()
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import logging
import time
from collections import deque
from contextlib import ContextDecorator

import torch

_BASE = logging.getLogger("echoseal")

REGISTRY_LEN = 4096      # host durations kept per span name
TRACE_CAP = 1 << 20      # span records a trace keeps; later ones are counted

_IDS = itertools.count(1)
# (trace, innermost open span, call id) while a trace is active, else None
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "echoseal_span", default=None)


class StructuredLogger:
    """JSON-line event logger with per-event-type rate limiting."""

    def __init__(self, name: str, min_interval_s: float = 0.1) -> None:
        self._log = _BASE.getChild(name)
        self._min_interval = min_interval_s
        self._last: dict[str, float] = {}

    def event(self, kind: str, _level: int = logging.DEBUG, **fields) -> None:
        now = time.monotonic()
        if now - self._last.get(kind, -1e9) < self._min_interval:
            return
        self._last[kind] = now
        if self._log.isEnabledFor(_level):
            self._log.log(_level, "%s %s", kind,
                          json.dumps(fields, default=str, sort_keys=True))

    def info(self, kind: str, **fields) -> None:
        self.event(kind, logging.INFO, **fields)

    def warning(self, kind: str, **fields) -> None:
        self.event(kind, logging.WARNING, **fields)


def get_logger(name: str, min_interval_s: float = 0.1) -> StructuredLogger:
    return StructuredLogger(name, min_interval_s)


class Trace:
    """The span records of one ``tracing()`` block, in the order the spans
    ended; ``dropped`` counts those past ``TRACE_CAP``."""

    def __init__(self) -> None:
        self.spans: list[dict] = []
        self.dropped = 0
        self._events: list[tuple[dict, list]] = []   # (attrs, marks)

    def _add(self, rec: dict, marks: list | None) -> None:
        if len(self.spans) >= TRACE_CAP:
            self.dropped += 1
            return
        self.spans.append(rec)
        if marks is not None and len(marks) > 1:
            self._events.append((rec["attrs"], marks))

    def resolve(self) -> None:
        """Turn each span's CUDA events into ``attrs["dev_ms"]``, device ms
        per marked stage (waits for the events)."""
        for attrs, marks in self._events:
            marks[-1][1].synchronize()
            attrs["dev_ms"] = {name: a.elapsed_time(b) for (_, a), (name, b)
                               in zip(marks, marks[1:])}
        self._events.clear()

    def drain(self) -> list[dict]:
        """The records so far, resolved, and an empty buffer."""
        self.resolve()
        spans, self.spans = self.spans, []
        return spans


@contextlib.contextmanager
def tracing():
    """Record every span opened in this context (thread or task) into a
    fresh ``Trace``; off outside it.  Leaving resolves the device events."""
    tr = Trace()
    token = _CURRENT.set((tr, None, None))
    try:
        yield tr
    finally:
        _CURRENT.reset(token)
        tr.resolve()


def span_attrs() -> dict | None:
    """The ``attrs`` of the innermost span open in this context while a
    trace is active (for code below the span that adds to it), else None."""
    cur = _CURRENT.get()
    return None if cur is None or cur[1] is None else cur[1].attrs


def _record_function(name: str):
    """A profiler range of ``name``: the C++ ``_RecordFunctionFast`` where
    torch has it, else ``torch.profiler.record_function``.

    ``record_function`` enters through a dispatcher op, and the first one
    in a process sets that op up after the range's start is stamped (1.2-
    1.7 ms on an idle CPU, 9 ms with the test suite's workers beside it),
    so the span's own stamp, taken after the enter, fell that far behind
    the profiler's; the fast range stamps and returns in microseconds."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is not None:
        return fast(name)
    return torch.profiler.record_function(name)


class Timer(ContextDecorator):
    """A span: host duration into ``registry``; a record while tracing."""

    registry: dict[str, deque[float]] = {}

    def __init__(self, name: str, **attrs) -> None:
        self.name = name
        self.attrs = attrs
        self.elapsed = 0.0
        self.id = None

    def __enter__(self):
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = _record_function(self.name)
            self._rf.__enter__()
        cur = _CURRENT.get()
        self._trace = self._marks = None
        if cur is not None:
            self._trace, parent, call = cur
            self.id = next(_IDS)
            self._parent = None if parent is None else parent.id
            self._call = self.id if call is None else call
            self._token = _CURRENT.set((self._trace, self, self._call))
            self._start_ns = time.time_ns()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        durations = self.registry.get(self.name)
        if durations is None:
            durations = self.registry[self.name] = deque(maxlen=REGISTRY_LEN)
        durations.append(self.elapsed)
        if self._trace is not None:
            end_ns = time.time_ns()
            _CURRENT.reset(self._token)
            self._trace._add(dict(name=self.name, call=self._call, id=self.id,
                                  parent=self._parent,
                                  start_ns=self._start_ns, end_ns=end_ns,
                                  attrs=self.attrs), self._marks)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False

    def marks_for(self, device) -> list | None:
        """A ``marks`` list for device work enqueued in this span (as
        ``run_device(marks=)`` takes), started with an event now; None
        unless a trace is active and ``device`` is CUDA."""
        if self._trace is None or torch.device(device).type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._marks = [("start", ev)]
        return self._marks

    @classmethod
    def report(cls) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in cls.registry.items():
            out[name] = dict(n=len(xs), total=sum(xs),
                             mean=sum(xs) / len(xs), max=max(xs))
        return out
