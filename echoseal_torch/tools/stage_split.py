"""Per-stage device times of both batch tiers and the single-clip latency of
both tiers, on one card: ``chip_smoke.py`` phases 4-5, 7-8, 16 and 17 on
the data those phases make (this script calls the set-up helpers of the
``chip_smoke.py`` beside this checkout's package), without their checks of
every verdict path.

    python3 echoseal_torch/tools/stage_split.py [--root DIR] [--runs N]

``echoseal_torch`` is imported from ``--root`` (default: the checkout this
file lies in), so that one call on the card can time two checkouts in
turns on the same data, for example a parent commit unpacked under
``build/parent``:

    for r in build/parent . . build/parent; do
        python3 echoseal_torch/tools/stage_split.py --root $r; done

It reads only what both checkouts offer: ``run_device(..., marks=)``, the
verifiers' public calls and the ``Timer`` spans.  Prints one JSON line:

- ``compat`` and ``v2``: B = 1024 clips of 3 s; after a warm-up, ``runs``
  ``run_device`` calls, each stage's CUDA-event ms (median over the runs,
  and every run), and the median of the host clock around each call and
  its synchronise;
- ``compat_single`` and ``v2_single``: 30 distinct 3.5 s cuts, a fresh
  ``WatermarkDetector`` per compat cut (built outside the timer), one
  ``RobustVerifier`` for v2; p50, p99 and mean ms of ``verify_detailed``,
  and the summed ``Timer`` spans.

Every clip must verify.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

CHECKOUT = Path(__file__).resolve().parents[2]


def _smoke():
    """This checkout's ``chip_smoke.py`` as a module (its ``main`` unrun)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CHECKOUT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stage_ms(start, marks) -> dict[str, float]:
    prev, out = start, {}
    for name, ev in marks:
        out[name] = prev.elapsed_time(ev)
        prev = ev
    return out


def _batch(torch, verifier, clips, nv, runs: int) -> dict:
    """Stage ms of ``runs`` ``run_device`` calls after a warm-up."""
    verifier.run_device(clips, nv)
    per_run, host_ms = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        marks = []
        t0 = time.perf_counter()
        start.record()
        out = verifier.run_device(clips, nv, marks=marks)
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        per_run.append(_stage_ms(start, marks))
        del out
    return {"stage_ms": {k: statistics.median(r[k] for r in per_run)
                         for k in per_run[0]},
            "runs_stage_ms": per_run,
            "run_device_ms": statistics.median(host_ms)}


def _single(torch, verify, clips) -> dict:
    from echoseal_torch.utils.logging import Timer

    Timer.registry.clear()
    ms = []
    for clip in clips:
        fn = verify()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(clip)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if not r.authentic:
            raise SystemExit(f"stage_split: a single clip rejected: {r}")
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "mean_ms": float(np.mean(ms)),
            "spans_s": {k: v["total"] for k, v in Timer.report().items()}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(CHECKOUT),
                    help="checkout whose echoseal_torch is timed")
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("stage_split: needs a CUDA card")
    from echoseal_torch.models import pipeline as pl
    from echoseal_torch.models import robust
    from echoseal_torch.models.detector import WatermarkDetector
    from echoseal_torch.ops import build

    if not Path(build.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"stage_split: imported {build.__file__}, "
                         f"not from {root}")
    sm = _smoke()
    key, fs, t35 = sm.KEY, sm.FS, sm.T35
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    out = {"root": str(root), "card": card}
    build.LAUNCHES.clear()

    # compat batch (phases 4-5)
    bv = pl.BatchVerifier(key, max_ctr=sm.MAX_CTR, peaks=sm.PEAKS)
    _, _, clips, nv = sm.compat_clips(torch, bv,
                                      np.random.default_rng(sm.SEED))
    if not bv.verify_batch(clips, nv).all():
        raise SystemExit("stage_split: a compat clip rejected")
    out["compat"] = _batch(torch, bv, clips, nv, args.runs)
    del bv, clips

    # v2 batch (phases 7-8)
    rv = pl.RobustBatchVerifier(key)
    _, _, clips = sm.v2_clips(torch, np.random.default_rng(sm.SEED + 1),
                              sm.tone_host(sm.STREAM_S_V2 * fs))
    if not rv.verify_batch(clips, nv).all():
        raise SystemExit("stage_split: a v2 clip rejected")
    out["v2"] = _batch(torch, rv, clips, nv, args.runs)
    del rv, clips
    torch.cuda.empty_cache()

    # compat single clip (phase 16): a fresh detector per cut
    _, stream, starts = sm.compat_single_cuts()
    cuts = [stream[s:s + t35] for s in starts]
    WatermarkDetector(key).verify_detailed(cuts[0], fs)      # warm-up

    def fresh_detector():
        det = WatermarkDetector(key)
        return lambda clip: det.verify_detailed(clip, fs)

    out["compat_single"] = _single(torch, fresh_detector, cuts)

    # v2 single clip (phase 17): one verifier
    _, stream, starts = sm.v2_single_cuts()
    cuts = [stream[s:s + t35] for s in starts]
    single = robust.RobustVerifier(key)
    single.verify_detailed(cuts[0], fs)                      # warm-up
    out["v2_single"] = _single(
        torch, lambda: (lambda clip: single.verify_detailed(clip, fs)), cuts)
    out["launches"] = dict(build.LAUNCHES)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
