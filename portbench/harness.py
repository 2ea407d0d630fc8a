"""One run of one benchmark cell: set-up, the measured window, the traced
run's layers, and the comparison that decides ``correct``.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration file and traffic mix, ``portbench/traffic/<traffic>.json``
holds the mix, ``portbench/limits/<workload>.json`` the limits of its
comparison, and ``portbench/metrics/<metric>.py`` the reader of each
per-layer metric.  A new cell or metric is new files and entries.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import check, gen, trace
from portbench.ref import verify as ref
from portbench.ref.bandplan import BAND_PLAN

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
        cell=cell, spec=spec,
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((pkg / "traffic" / f"{cell['traffic']}.json")
                           .read_text()),
        limits=json.loads((pkg / "limits" / f"{name}.json").read_text()),
        end_to_end=end,
        per_layer=[m for m in spec["per_layer"]
                   if reported(m) and m["moves"] in moved])


def metric_reader(name: str, root: Path = ROOT):
    """``portbench/metrics/<name>.py``'s ``read(ctx)``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


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


_CAP: dict = {}


def _hook(verifier) -> None:
    """Keep each call's stage outputs and ladder rungs in ``_CAP`` for the
    check: the verifier's ``run_device`` and the ladder's
    ``pipeline.scl_decode_serving``, each wrapped once."""
    from echoseal_torch.models import pipeline

    if not hasattr(verifier, "_portbench_run"):
        run = verifier._portbench_run = verifier.run_device

        def run_device(*a, **k):
            _CAP["out"] = run(*a, **k)
            return _CAP["out"]

        verifier.run_device = run_device
    if not hasattr(pipeline.scl_decode_serving, "_portbench"):
        decode = pipeline.scl_decode_serving

        def scl_decode_serving(llr, spec, list_size):
            res = decode(llr, spec, list_size)
            _CAP.setdefault("rungs", []).append(
                (llr.shape[0], list_size, res))
            return res

        scl_decode_serving._portbench = True
        pipeline.scl_decode_serving = scl_decode_serving


class BatchCell:
    """A closed loop of ``verify_batch`` calls, one client, over the
    traffic's distinct batches in turn."""

    entry = "batch"

    def __init__(self, cell: dict, seed: int, device, verifier=None) -> None:
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.device = device
        t0 = time.perf_counter()
        self.verifier = verifier or build_system(self.config, "batch", device)
        t1 = time.perf_counter()
        self.stream, self.batches = gen.make_batches(
            self.config, self.traffic, seed, device)
        self.setup_parts = {"verifier_s": t1 - t0,
                            "inputs_s": time.perf_counter() - t1}
        self.T = int(round(self.traffic["clip_s"] * self.config["fs"]))
        self.captures: dict[int, dict] = {}
        _hook(self.verifier)

    def call(self, i: int):
        """One request: batch ``i % batches``; returns (batch, verdicts,
        accepts) and keeps the call's stage outputs as that batch's."""
        b = i % len(self.batches)
        batch = self.batches[b]
        _CAP.clear()
        if hasattr(self.verifier, "scl_rungs"):
            self.verifier.scl_rungs = []
        details: dict = {}
        with torch.profiler.record_function("portbench.verify_batch"):
            verdicts = self.verifier.verify_batch(batch.clips, batch.n_valid,
                                                  details=details)
        self.captures[b] = dict(_CAP)
        accepts = {i: (d.session_nonce, int(d.frame_ctr), d.stage)
                   for i, d in details.items()}
        return b, np.asarray(verdicts, bool), accepts

    def warm_up(self) -> None:
        for i in range(len(self.batches)):
            self.call(i)

    def work(self, b: int) -> float:
        return self.batches[b].seconds

    def check(self, records: list) -> dict:
        """Every comparison number of the cell (after the window)."""
        wave = self.config["waveform"]
        tab = reference_tables(self.config, "batch", self.device)
        caps = {}
        for b, c in self.captures.items():
            rungs = [(n, L, ref.crc_paths(res)) for n, L, res
                     in c.get("rungs", [])]
            caps[b] = dict(out=c["out"], rungs=rungs)
        st = settings(self.config, "batch")
        return check.compare(wave, tab, self.batches, self.stream, records,
                             caps, st.get("list_size"), st["peaks"], self.T)

    def free_program(self) -> None:
        """Drop the program's tables; the captured outputs stay."""
        self.verifier.tables = None

    def sync_rows(self):
        for b in self.batches:
            yield b.clips, b.n_valid


class SingleCell:
    """A closed loop of single-clip requests, one client: each request one
    cut of the pool, as numpy host audio, through one detector built in
    set-up (the way a stream monitor holds one)."""

    entry = "single"

    def __init__(self, cell: dict, seed: int, device, verifier=None) -> None:
        from echoseal_torch.models import detector

        self.config, self.traffic = cell["config"], cell["traffic"]
        self.device = device
        t0 = time.perf_counter()
        self.verifier = verifier or build_system(self.config, "single",
                                                 device)
        t1 = time.perf_counter()
        self.stream, self.cuts, self.order = gen.make_cuts(
            self.config, self.traffic, seed)
        self.setup_parts = {"verifier_s": t1 - t0,
                            "inputs_s": time.perf_counter() - t1}
        self.T = int(round(self.traffic["clip_s"] * self.config["fs"]))
        self.fs = self.config["fs"]
        self.captures: dict[int, dict] = {}
        self.batches = self.cuts          # the unit a traced run covers once
        if not hasattr(detector._scan_stage, "_portbench"):
            scan = detector._scan_stage

            def _scan_stage(*a, **k):
                _CAP["out"] = scan(*a, **k)
                return _CAP["out"]

            _scan_stage._portbench = True
            detector._scan_stage = _scan_stage

    def call(self, i: int):
        c = int(self.order[i % self.order.size])
        _CAP.clear()
        with torch.profiler.record_function("portbench.verify_detailed"):
            res = self.verifier.verify_detailed(self.cuts[c].audio, self.fs)
        if "out" in _CAP:
            o = _CAP["out"]
            self.captures[c] = {k: o[k] for k in ("peak_idx", "peak_val",
                                                  "chips_d")}
        accepts = {}
        if res.authentic:
            band = [tuple(b) for b in BAND_PLAN].index(tuple(res.band))
            accepts[0] = (res.session_nonce, int(res.frame_ctr), res.stage,
                          int(res.peak_pos), band)
        return c, np.array([bool(res.authentic)]), accepts

    def warm_up(self) -> None:
        """One pass over the pool: every shape and path the requests use."""
        for i in range(len(self.cuts)):
            self.call(i)

    def work(self, c: int) -> float:
        return self.T / self.fs

    def check(self, records: list) -> dict:
        cfg = self.config
        tab = reference_tables(cfg, "single", self.device)
        return check.compare_single(tab, self.cuts, self.stream, records,
                                    self.captures,
                                    settings(cfg, "single")["peaks"], self.T)

    def free_program(self) -> None:
        self.verifier.tables = None

    def sync_rows(self):
        """Each cut zero-padded as the scan pads it, with its length."""
        for cut in self.cuts:
            x = torch.zeros(1, ref.pad_bucket(max(self.T, 2 * 1215 + 512)),
                            device=self.device)
            x[0, :self.T] = torch.as_tensor(cut.audio, device=self.device)
            yield x, torch.tensor([self.T], device=self.device)


RUNNERS = {"batch": BatchCell, "single": SingleCell}


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
    vals = {"setup_s": setup_s}
    if "audio_s_per_s" in names:
        vals["audio_s_per_s"] = win["work"] / win["window_s"]
    if "clip_p50_ms" in names:
        vals["clip_p50_ms"] = 1e3 * statistics.median(win["latencies"])
    if "clip_p95_ms" in names:
        vals["clip_p95_ms"] = 1e3 * quantile(win["latencies"], 0.95)
    return {n: vals[n] for n in names}


def device_info(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run(name: str, seed: int, seconds: float, traced: bool, *,
        t_start: float, device=None, overrides: dict | None = None,
        control: bool = False, fault=None, root: Path = ROOT) -> dict:
    """One run of cell ``name``; returns the result line's object.

    ``overrides`` replaces traffic keys (tests run at small sizes),
    ``control`` runs the program with TF32 products (the comparison's
    control), ``fault(runner)`` breaks the timed path (the tests' faults),
    ``root`` holds the ``BENCHMARK.json`` that names the cell.

    ``failed`` counts the clips whose answer the comparison calls wrong
    (``check``'s ``wrong``); ``rejected`` the clips the verifier rejected,
    which on an impaired channel the reference rejects too.
    """
    t_entry = time.perf_counter()
    cell = load_cell(name, root)
    cell["traffic"] = dict(cell["traffic"], **(overrides or {}))
    device = torch.device(device or "cuda")
    chips = cell["cell"]["chips"]
    entry = cell["traffic"]["entry"]
    runner = RUNNERS[entry](cell, seed, device)
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
    win = window(runner, seconds, on_call)
    if traced:
        ctx["spans"] = {k: list(v) for k, v in Timer.registry.items()}
        ctx["requests"] = win["calls"]
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
