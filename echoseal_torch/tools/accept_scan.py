"""Count compat clip rejections and their cause over many fresh batches.

Run from the repository root on a CUDA card::

    python3 -m echoseal_torch.tools.accept_scan --runs 48 [--batch 1024]

Each run synthesises a new 4096-frame stream with the port's host TX (every
random byte drawn from ``--seed`` + run), cuts the same B clips of 3 s as
``chip_smoke.py``, runs ``BatchVerifier.run_device`` once, and counts over
the (B, 4, peaks) candidate lattice:

* ``crc_fail``: candidates whose hard decode fails CRC-8;
* ``crc_false_pass``: candidates that pass CRC-8 but not the AEAD ladder;
* ``first_rule_rejects``: clips rejected when only each clip's first
  CRC-passing candidate is opened (the JAX package's verdict rule);
* ``rejects``: clips the port's verdict (``finish_host``) rejects;
* ``no_authentic``: clips none of whose candidates authenticates.

One JSON line per run, then a line of totals.  ``--out`` writes the lines
to a file as well.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from echoseal_torch.core.params import FRAME_LEN
from echoseal_torch.models import pipeline as pl
from echoseal_torch.models.embedder import frames_np
from echoseal_torch.ops import demod

KEY = bytes.fromhex("aa" * 32)
FS = 48_000
T = 3 * FS
TPAD = T + 8192
STREAM_FRAMES = 4096
SCALE = 10.0 ** (-35.0 / 20.0)


def scan_run(bv: pl.BatchVerifier, starts: np.ndarray,
             rng: np.random.Generator) -> dict:
    """One fresh batch -> counts (see the module docstring)."""
    dev = bv.device
    B = starts.size
    stream = torch.from_numpy(frames_np(
        bv.sec, bv._hop, np.arange(STREAM_FRAMES), bytes(8),
        rng=rng).reshape(-1)).to(dev)
    clips = torch.zeros(B, TPAD, device=dev)
    clips[:, :T] = demod.slice_windows(
        stream, torch.from_numpy(starts).to(dev), T) * SCALE
    nv = torch.full((B,), T, dtype=torch.int32, device=dev)
    out = bv.run_device(clips, nv)
    verdicts = bv.finish_host(out)

    crc = out["crc_ok"].reshape(B, -1).cpu().numpy()
    ctr = out["ctr"].reshape(B, -1).cpu().numpy()
    info = out["info_bits"].reshape(B, crc.shape[1], -1).to(
        torch.uint8).cpu().numpy()
    ii, cc = np.nonzero(crc)
    opened = bv._accept_blobs(
        [b.tobytes() for b in np.packbits(info[ii, cc], axis=-1)],
        ctr[ii, cc], None)
    auth = np.zeros_like(crc)
    auth[ii, cc] = [n is not None for n in opened]
    first_ok = auth[np.arange(B), crc.argmax(1)] & crc.any(1)
    return dict(clips=B, candidates=int(crc.size),
                crc_fail=int((~crc).sum()),
                crc_false_pass=int((crc & ~auth).sum()),
                first_rule_rejects=int((~first_ok).sum()),
                rejects=int((~verdicts).sum()),
                no_authentic=int((~auth.any(1)).sum()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=48)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()

    bv = pl.BatchVerifier(KEY, max_ctr=16_384, peaks=2, device=args.device)
    n_frames = -(-T // FRAME_LEN)
    starts = np.random.default_rng(args.seed).integers(
        0, STREAM_FRAMES - n_frames, args.batch) * FRAME_LEN
    lines, total = [], {}
    t0 = time.perf_counter()
    for run in range(args.runs):
        rec = scan_run(bv, starts, np.random.default_rng(args.seed + run))
        for k, v in rec.items():
            total[k] = total.get(k, 0) + v
        lines.append(json.dumps(dict(run=run, **rec)))
        print(lines[-1], flush=True)
    lines.append(json.dumps(dict(total=total, runs=args.runs,
                                 seconds=time.perf_counter() - t0)))
    print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
