"""One run of one benchmark cell: set-up, the measured window, the traced
run's layers, and the comparison that decides ``correct``.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration file and traffic mix, ``portbench/traffic/<traffic>.json``
holds the mix, ``portbench/runners/<entry>.py`` the runner of the mix's
``entry`` (with its comparison), ``portbench/limits/<workload>.json`` the
limits of that comparison, ``portbench/metrics/<metric>.py`` the reader
of each per-layer metric, and ``gen`` finds the hosts and channels.  A new
cell, metric or deployment is new files and entries.
"""
from __future__ import annotations

import importlib
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from portbench import named, trace
from portbench.ref import verify as ref

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "echoseal_tpu")


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic mix, limits and per-layer metrics."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}")
    cell = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    pkg = root / "portbench"

    def reported(m):
        return m.get("workloads") is None or name in m["workloads"]

    end = [m for m in spec["end_to_end"] if reported(m)]
    moved = {m["name"] for m in end}
    return dict(
        cell=cell, spec=spec, root=root, ranks=None,
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((pkg / "traffic" / f"{cell['traffic']}.json")
                           .read_text()),
        limits=json.loads((pkg / "limits" / f"{name}.json").read_text()),
        end_to_end=end,
        per_layer=[m for m in spec["per_layer"]
                   if reported(m) and m["moves"] in moved])


def metric_reader(name: str, root: Path = ROOT):
    """``portbench/metrics/<name>.py``'s ``read(ctx)``."""
    return named.load("metrics", name, root).read


def runner_class(entry: str, root: Path = ROOT):
    """``portbench/runners/<entry>.py``'s ``Runner`` (the interface:
    ``portbench/runners/__init__.py``)."""
    return named.load("runners", entry, root).Runner


def build_system(config: dict, entry: str, device):
    """The configuration's verifier for the traffic's entry."""
    v = config["verifier"][entry]
    cls = getattr(importlib.import_module(v["module"]), v["class"])
    return cls(bytes.fromhex(config["key_hex"]), device=device,
               **v.get("kwargs", {}))


def settings(config: dict, entry: str) -> dict:
    """What both sides run for the entry: the verifier's ``kwargs``, and
    its ``fixed`` values for settings the class takes no argument for."""
    v = config["verifier"][entry]
    return {**v.get("fixed", {}), **v.get("kwargs", {})}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def reference_tables(config: dict, entry: str, device) -> dict:
    """The plain reference's tables for the configuration."""
    key, fs = bytes.fromhex(config["key_hex"]), config["fs"]
    st = settings(config, entry)
    mk = ref.compat_tables if config["waveform"] == "compat" else ref.v2_tables
    return mk(key, fs, st["max_ctr"], device)


def window(cell_run, seconds: float, on_call=None) -> dict:
    """Calls in a closed loop until ``seconds`` have passed; the window
    ends when the last call returns."""
    records, lat, work = [], [], 0.0
    t0 = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        rec = cell_run.call(i)
        t1 = time.perf_counter()
        records.append(rec)
        lat.append(t1 - t)
        work += cell_run.work(rec[0])
        if on_call is not None:
            on_call(cell_run, rec)
        i += 1
        if t1 - t0 >= seconds:
            break
    return dict(records=records, latencies=lat, work=work,
                window_s=t1 - t0, calls=i)


def quantile(xs: list[float], q: float) -> float:
    """The ``q`` quantile of all ``xs`` (``statistics.quantiles``)."""
    if len(xs) < 2:
        return xs[0]
    return statistics.quantiles(xs, n=100, method="exclusive")[
        round(q * 100) - 1]


def end_to_end(names: list[str], win: dict, setup_s: float) -> dict:
    """The cell's end-to-end metrics of one window.  ``audio_s_per_card_s``
    is the window's work over ``win["busy_s"]``, the seconds in which an
    operation ran on the card (``trace.device_busy``), and is left out of
    a run with no card."""
    vals = {"setup_s": setup_s}
    if "audio_s_per_s" in names:
        vals["audio_s_per_s"] = win["work"] / win["window_s"]
    if "audio_s_per_card_s" in names and win.get("busy_s"):
        vals["audio_s_per_card_s"] = win["work"] / win["busy_s"]
    if "clip_p50_ms" in names:
        vals["clip_p50_ms"] = 1e3 * statistics.median(win["latencies"])
    if "clip_p95_ms" in names:
        vals["clip_p95_ms"] = 1e3 * quantile(win["latencies"], 0.95)
    return {n: vals[n] for n in names if n in vals}


def device_info(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def build(name: str, seed: int, device, overrides: dict | None = None,
          root: Path = ROOT, ranks=None) -> tuple[dict, object]:
    """Cell ``name`` with ``overrides`` on its traffic, and its runner."""
    cell = load_cell(name, root)
    cell["traffic"] = dict(cell["traffic"], **(overrides or {}))
    cell["ranks"] = ranks
    return cell, runner_class(cell["traffic"]["entry"], root)(
        cell, seed, device)


def run(name: str, seed: int, seconds: float, traced: bool, *,
        t_start: float, device=None, overrides: dict | None = None,
        control: bool = False, fault=None, root: Path = ROOT,
        ranks=None) -> dict:
    """One run of cell ``name``; returns the result line's object.

    ``overrides`` replaces traffic keys (tests run at small sizes),
    ``control`` runs the program with TF32 products (the comparison's
    control), ``fault(runner)`` breaks the timed path (the tests' faults),
    ``root`` holds the ``BENCHMARK.json`` that names the cell, ``ranks``
    is rank 0's ``launch.Ranks`` on a cell of N > 1 cards (each call is
    then stepped on every rank: ``launch.lead``).

    A ``--trace 0`` run on the card of a cell with an end-to-end metric
    from the device trace runs its window under ``trace.device_busy``.

    ``failed`` counts the clips whose answer the comparison calls wrong
    (``check``'s ``wrong``); ``rejected`` the clips the verifier rejected,
    which on an impaired channel the reference rejects too.
    """
    t_entry = time.perf_counter()
    device = torch.device(device or "cuda")
    cell, runner = build(name, seed, device, overrides, root, ranks)
    chips = cell["cell"]["chips"]
    if ranks is not None:
        from portbench import launch

        launch.lead(runner, ranks)
    if control:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    if fault is not None:
        fault(runner)
    t_warm = time.perf_counter()
    runner.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    parts = dict(imports_s=t_entry - t_start, **runner.setup_parts,
                 warm_up_s=t_start + setup_s - t_warm)
    ctx: dict = {"cell": cell, "runner": runner, "rungs": []}
    on_call = None
    if traced:
        from echoseal_torch.utils.logging import Timer

        def on_call(r, rec):
            ctx["rungs"].append(list(getattr(r.verifier, "scl_rungs", [])))

        Timer.registry.clear()          # global: holds every earlier call
    if not traced and device.type == "cuda" and any(
            m["source"] == "device_trace" for m in cell["end_to_end"]):
        win, busy_s = trace.device_busy(
            lambda: window(runner, seconds, on_call))
        win["busy_s"] = busy_s
    else:
        win = window(runner, seconds, on_call)
    if traced:
        ctx["spans"] = {k: list(v) for k, v in Timer.registry.items()}
        ctx["requests"] = win["calls"]
        ctx["window"] = win
    dev = device_info(device, chips)
    metrics: dict = {}
    breakdown = None
    if traced:
        ctx.update(trace.layers(runner))
        dev.update(busy_s=ctx["profile"]["busy_s"],
                   window_s=ctx["profile"]["window_s"])
        breakdown = ctx["profile"]["breakdown"]
        for m in cell["per_layer"]:
            v = metric_reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        vals = end_to_end([m["name"] for m in cell["end_to_end"]], win,
                          setup_s)
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in vals.items()}
    runner.free_program()
    limits = cell["limits"]
    found = runner.check(win["records"])
    nums = {k: v for k, v in found.items() if k in limits}
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    correct = set(nums) == set(limits) and all(
        v <= limits[k] for k, v in nums.items())
    attempted = sum(len(r[1]) for r in win["records"])
    out = {"correct": correct, "attempted": attempted,
           "failed": int(found["wrong"]),
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["rejected"] = sum(int((~r[1]).sum()) for r in win["records"])
    out["setup_parts"] = parts
    out["checks"] = checks
    return out
