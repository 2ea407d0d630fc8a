"""The program's own spans over a traced run's calls, for the readers of
``program_span`` metrics: once per run, inside the program's
``echoseal_torch.utils.logging.tracing()`` and with no profiler on, the
cell's calls for one pass over its batches and at least
``trace.PROFILE_S`` seconds, as ``trace.profiled`` makes them.  The
drained span records and the number of calls are cached in
``ctx["program"]``; None where the program has no ``tracing``."""
from __future__ import annotations

import time

from portbench import trace


def program(ctx):
    """{"spans": records, "calls": n}, or None without program tracing."""
    if "program" not in ctx:
        ctx["program"] = _run(ctx["runner"])
    return ctx["program"]


def _run(runner):
    try:
        from echoseal_torch.utils.logging import tracing
    except ImportError:
        return None
    with tracing() as tr:
        t0, i = time.perf_counter(), 0
        while (i < len(runner.batches)
               or time.perf_counter() - t0 < trace.PROFILE_S):
            runner.call(i)
            i += 1
        spans = tr.drain()
    return {"spans": spans, "calls": i}


def per_call_ms(ctx, keep) -> float | None:
    """Host ms a call of the spans whose name ``keep(name)`` holds,
    summed, mean over the calls (a call without one counts 0)."""
    prog = program(ctx)
    if not prog or not prog["calls"]:
        return None
    ns = sum(s["end_ns"] - s["start_ns"] for s in prog["spans"]
             if keep(s["name"]))
    return 1e-6 * ns / prog["calls"]
