"""This checkout's SCL kernel against another copy of its source (a parent
commit's, say), in turns on one card.

    python3 -m echoseal_torch.tools.scl_ab --other build/parent/scl_decode.cu \
        [--only exact|serving]

Builds ``--other`` with ``ops/build.py``'s nvcc flags into
``build/echoseal_torch/ab/`` and, at every shape of ``chip_smoke.py``'s
phase 3c (the exact decoder, ``SCL_SHAPES``) and phase 3d (the serving
decoder, ``SERVING_SHAPES``), on the rows those phases make (the same seeds:
AWGN, then a noiseless and an all-zero row), decodes with both builds.
Prints one JSON line per shape:

- ``hash``: a SHA-256 prefix of each build's outputs (info bits, crc_ok,
  metrics) and ``identical``, whether the two agree bit for bit;
- ``agreement``: this checkout's lists against the eager walk
  (``scl.list_agreement``; ``_scl_decode_plain`` or the serving walk);
- ``turns_ms``: CUDA-event ms of each build in turns other, this, this,
  other (10 launches each, the median; the card kept busy before each
  start event, L2 flushed: ``chip_smoke.cuda_ms``), ``ms`` their means and
  ``ratio`` this over other;
- serving shapes: each build's leaf-fork and node-fork rounds
  (``chip_smoke._fork_round_ms``, ``_node_round_ms``) in µs.

Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from echoseal_torch.core.profiles import ROBUST, profile_spec
from echoseal_torch.ops import build, polar, scl

CHECKOUT = Path(__file__).resolve().parents[2]
ORDER = ("other", "this", "this", "other")


def _smoke():
    """This checkout's ``chip_smoke.py`` as a module (its ``main`` unrun)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CHECKOUT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bind_other(source: Path) -> tuple:
    """``scl.bind`` of ``source`` built with the port's nvcc flags."""
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = out_dir / f"libscl_ab-{digest}.so"
    if not lib.exists():
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                        str(source)], check=True)
    return scl.bind(ctypes.CDLL(str(lib)))


def _digest(out: dict) -> str:
    h = hashlib.sha256()
    for k in ("info_bits", "crc_ok", "metrics"):
        h.update(out[k].cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _rows(smoke, spec, rows: int, sigma: float, rng) -> torch.Tensor:
    """Phase 3c's and 3d's rows: AWGN, then a noiseless and a zero row."""
    _, llr_np = smoke._coded_rows(spec, rows, sigma, rng)
    llr_np[-2] = np.clip(smoke._coded_rows(spec, 1, 1e-3, rng)[1][0], -16, 16)
    llr_np[-1] = 0.0
    return torch.from_numpy(llr_np).cuda()


def _compare(smoke, decode, kernels, flush, busy, walk) -> dict:
    outs = {who: decode(k) for who, k in kernels.items()}
    torch.cuda.synchronize()
    line = {"hash": {who: _digest(o) for who, o in outs.items()}}
    line["identical"] = line["hash"]["this"] == line["hash"]["other"]
    agree = scl.list_agreement(outs["this"], walk(), smoke.SCL_TOL)
    line["agreement"] = {k: agree[k] for k in (
        "holds", "mismatched", "ties", "max_metric_err", "crc_pass_rows")}
    turns = {"other": [], "this": []}
    for who in ORDER:
        turns[who].append(smoke.cuda_ms(lambda: decode(kernels[who]), torch,
                                        n=10, flush=flush, busy=busy))
    line["turns_ms"] = turns
    line["ms"] = {who: statistics.mean(t) for who, t in turns.items()}
    line["ratio"] = line["ms"]["this"] / line["ms"]["other"]
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--only", choices=("exact", "serving"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scl_ab: needs a CUDA card")
    smoke = _smoke()
    kernels = {"other": _bind_other(args.other), "this": scl._kernel()}
    specs = {"compat": polar.polar_spec(), "v2": profile_spec(ROBUST)}
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    busy, mhz = smoke.busy_cycles(torch)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "sm_mhz": mhz,
                      "other": str(args.other)}), flush=True)
    if args.only != "serving":
        rng = np.random.default_rng(smoke.SEED + 13)
        for name, rows, L, sigma in smoke.SCL_SHAPES:
            spec = specs[name]
            x = _rows(smoke, spec, rows, sigma, rng)
            line = _compare(
                smoke, lambda k: scl.scl_decode_kernel(x, spec, L, kernel=k),
                kernels, flush, busy,
                lambda: scl._scl_decode_plain(x, spec, L))
            print(json.dumps({"decoder": "exact", "spec": name, "rows": rows,
                              "L": L, **line}), flush=True)
    if args.only != "exact":
        rng = np.random.default_rng(smoke.SEED + 14)
        for name, rows, L, block_seg in smoke.SERVING_SHAPES:
            spec = specs[name]
            x = _rows(smoke, spec, rows, smoke.SERVING_SIGMA, rng)
            line = _compare(
                smoke, lambda k: scl.scl_decode_serving_kernel(
                    x, spec, L, block_seg, kernel=k),
                kernels, flush, busy,
                lambda: scl._walk_decode(x, spec, L, serving=True,
                                         block_seg=block_seg))
            for who, k in kernels.items():
                line[f"{who}_fork_round_us"] = 1e3 * smoke._fork_round_ms(
                    torch, scl, spec, L, busy, block_seg=block_seg, kernel=k)
                line[f"{who}_node_round_us"] = 1e3 * smoke._node_round_ms(
                    torch, scl, spec, L, busy, block_seg, kernel=k)
            print(json.dumps({"decoder": "serving", "spec": name,
                              "rows": rows, "L": L, "block_seg": block_seg,
                              **line}), flush=True)


if __name__ == "__main__":
    main()
