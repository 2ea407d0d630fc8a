"""Structured, rate-limited logging + timers.

Diagnostics are opt-in, structured, and rate-limited so they can stay
enabled in production without perturbing the pipeline.  ``Timer`` reads
the host clock: around asynchronous device work it measures until the
next point where the host waits for the device (a download).

    from echoseal_torch.utils.logging import get_logger, Timer
    log = get_logger("rx")
    log.event("peak", band=2, idx=14580, corr=0.91)   # <= rate-limited
    with Timer("scan") as t: ...
"""
from __future__ import annotations

import json
import logging
import time
from contextlib import ContextDecorator

_BASE = logging.getLogger("echoseal")


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


class Timer(ContextDecorator):
    """Wall-clock timer; accumulates into a global registry for reports."""

    registry: dict[str, list[float]] = {}

    def __init__(self, name: str) -> None:
        self.name = name
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        self.registry.setdefault(self.name, []).append(self.elapsed)
        return False

    @classmethod
    def report(cls) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in cls.registry.items():
            out[name] = dict(n=len(xs), total=sum(xs),
                             mean=sum(xs) / len(xs), max=max(xs))
        return out


def trace_device(name: str):
    """``torch.profiler`` annotation context (shows in profiler traces)."""
    import torch

    return torch.profiler.record_function(name)
