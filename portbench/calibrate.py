"""Readings for the limits of a cell's comparison (not run by the
benchmark's own runs).

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--seconds 2] [--root <checkout>]

``--root`` names a checkout whose ``BENCHMARK.json`` lists the cell, for
a cell this one's does not list (``portbench.tests.pb_fixtures.
with_single_clip`` makes one with the single-clip cell).

In one process (the verifier's set-up is paid once): for each seed the
cell's traffic, a warm-up and a short window at the cell's own load, then
the comparison; for each control seed the same with the program's float32
products in TF32 (``torch.backends.cuda.matmul.allow_tf32``), the nearest
precision below the configuration's; for each SCL-control seed the same
with the program's fast-SSCL ladder (``ECHOSEAL_SCL_SERVING=1``), the
approximate decoder beside the exact one.  Every v2 seed also reads the
soft rows' control: the reference's own soft rows computed in bfloat16
against the float64 ones (``soft_llr_err_bf16`` in ``diag``).  For each
sync-control seed, the reference's own sync with its operands rounded one
precision below the configuration's sync (``--sync-rounding tf32`` for
float32, ``fp8`` for bf16) against the float64 one.  Prints one JSON line
per run.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--scl-control-seeds", default="")
    ap.add_argument("--sync-control-seeds", default="")
    ap.add_argument("--sync-rounding", choices=("tf32", "fp8"))
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--root", type=Path, default=ROOT)
    a = ap.parse_args()
    import torch

    from portbench import check, harness
    from portbench.ref import verify as ref

    check.LLR_CONTROL = True
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(a.workload, a.root)
    dev = torch.device("cuda")
    entry = cell["traffic"]["entry"]
    verifier = harness.build_system(cell["config"], entry, dev)
    Runner = harness.runner_class(entry, a.root)
    runs = [(int(s), False) for s in a.seeds.split(",") if s] + \
        [(int(s), True) for s in a.control_seeds.split(",") if s] + \
        [(int(s), "scl") for s in a.scl_control_seeds.split(",") if s]
    for seed, control in runs:
        torch.backends.cuda.matmul.allow_tf32 = control is True
        torch.backends.cudnn.allow_tf32 = control is True
        if control == "scl":        # the program's fast-SSCL ladder
            os.environ["ECHOSEAL_SCL_SERVING"] = "1"
        else:
            os.environ.pop("ECHOSEAL_SCL_SERVING", None)
        verifier.session_nonce = None     # a new stream is a new session
        runner = Runner(cell, seed, dev, verifier)
        runner.warm_up()
        win = harness.window(runner, a.seconds)
        check.DIAG.clear()
        t = time.perf_counter()
        nums = runner.check(win["records"])
        print(json.dumps({
            "workload": a.workload, "seed": seed, "control": control,
            "calls": win["calls"], "nums": nums, "diag": dict(check.DIAG),
            "reference_s": time.perf_counter() - t,
            "accepted": int(sum(r[1].sum() for r in win["records"])),
            "attempted": int(sum(r[1].size for r in win["records"])),
            "stages": {st: sum(d[2] == st for r in win["records"]
                               for d in r[2].values())
                       for st in {d[2] for r in win["records"]
                                  for d in r[2].values()}},
            "p50_ms": 1e3 * statistics.median(win["latencies"]),
            "audio_s_per_s": win["work"] / win["window_s"]}), flush=True)
        del runner
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cell["config"]
    for s in [int(s) for s in a.sync_control_seeds.split(",") if s]:
        runner = Runner(cell, s, dev, verifier)
        tab = harness.reference_tables(cfg, entry, dev)
        rnd = ref.round_tf32 if a.sync_rounding == "tf32" else ref.round_fp8
        peaks = harness.settings(cfg, entry)["peaks"]
        errs = []
        for x, nv in runner.sync_rows():
            _, want = ref.sync_peaks(x, nv, tab, peaks)
            _, low = ref.sync_peaks(x, nv, tab, peaks, rounding=rnd)
            errs.append(check.sync_err(low, want))
        print(json.dumps({"workload": a.workload, "seed": s,
                          "sync_control": a.sync_rounding,
                          "sync_val_err": max(errs)}), flush=True)
        del runner, tab
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
