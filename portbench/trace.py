"""The traced run's readings: CUDA-event stage times of ``run_device``,
the host finish, and a ``torch.profiler`` window over calls of the cell's
entry (busy and idle time of the device, kernels by name, idle gaps by
what the host was doing); and the device's busy seconds of a measured
window, for end-to-end metrics taken from the device trace."""
from __future__ import annotations

import time

import torch

PROFILE_S = 2.0        # least host seconds of profiled calls
MARKED_ROUNDS = 2      # marked passes over each distinct batch


def marked_stages(runner) -> dict:
    """Per marked pass over each batch: stage ms and the host finish."""
    v = runner.verifier
    stages, finish = [], []
    for _ in range(MARKED_ROUNDS):
        for batch in runner.batches:
            marks: list = []
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            out = v.run_device(batch.clips, batch.n_valid, marks=marks)
            torch.cuda.synchronize()
            t = time.perf_counter()
            v.finish_host(out)
            finish.append(time.perf_counter() - t)
            prev, ms = start, {}
            for name, ev in marks:
                ms[name] = prev.elapsed_time(ev)
                prev = ev
            stages.append(ms)
            del out
    return {"stages": stages, "finish_s": finish}


def _union(iv: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(dev: list, cpu: list, w0: int, w1: int) -> dict:
    """Busy and idle seconds of ``[w0, w1]`` (ns) from device intervals
    ``(start, end, name)``; the 10 costliest kernels and 10 longest idle
    gaps, each gap named by the innermost host span open at its middle."""
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in dev])
    busy_ns = sum(b - a for a, b in busy)
    by_name: dict[str, int] = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0) + (b - a)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])

    def label(t: int) -> str:
        best = None
        for a, b, n in cpu:
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, n)
        return best[2] if best else "host"

    window_s = (w1 - w0) / 1e9
    return {
        "busy_s": busy_ns / 1e9, "window_s": window_s,
        "idle_pct": 100.0 * (1.0 - busy_ns / max(w1 - w0, 1)),
        "breakdown": {
            "device_ops": [[n, t / 1e9] for n, t in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[label((a + b) // 2), (b - a) / 1e9]
                          for a, b in gaps[:10]]}}


def device_busy(fn):
    """``fn()`` under ``torch.profiler`` with device activity only (no host
    ops are recorded); returns ``fn``'s result and the seconds in which a
    kernel, copy or set ran on the card from the profiler's start to the
    synchronize after ``fn`` (the union of CUPTI's intervals)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    iv = [(e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda and not e.is_user_annotation()
          and not e.name().startswith("portbench.")]
    return out, sum(b - a for a, b in _union(iv)) / 1e9


def profiled(runner) -> dict:
    """A bounded, steady run of the entry under ``torch.profiler``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        with torch.profiler.record_function("portbench.window"):
            t0, i = time.perf_counter(), 0
            while (i < len(runner.batches)
                   or time.perf_counter() - t0 < PROFILE_S):
                runner.call(i)
                i += 1
            torch.cuda.synchronize()
    dev, cpu, win = [], [], None
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == cuda:
            if not (e.is_user_annotation()
                    or e.name().startswith("portbench.")):
                dev.append((a, b, e.name()))
        else:
            cpu.append((a, b, e.name()))
            if e.name() == "portbench.window":
                win = (a, b)
    if win is None or not dev:
        return {"busy_s": None, "window_s": None, "idle_pct": None,
                "breakdown": {"device_ops": [], "idle_gaps": []}, "calls": i}
    return dict(summarize(dev, [c for c in cpu if c[2] != "portbench.window"],
                          *win), calls=i)


def layers(runner) -> dict:
    """Everything the per-layer readers of a traced run read (on the card)."""
    marked = marked_stages(runner) if runner.entry == "batch" else None
    return {"marked": marked, "profile": profiled(runner)}
