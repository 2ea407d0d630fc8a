"""Measured capability envelope: accept rates across hosts x impairments.

Runs both single-clip verifiers (compat ``WatermarkDetector`` and v2
``RobustVerifier``, on ``device``) over a grid of host signals and
channel impairments and prints a JSON report: the measured envelope
behind the statement that the compat wire format survives only
digitally clean capture while the v2 profile survives real channels.
"""
from __future__ import annotations

import json

import numpy as np


def main(key: bytes = b"\xaa" * 32, seconds: float = 4.0,
         device=None) -> dict:
    from echoseal_torch.models.detector import WatermarkDetector
    from echoseal_torch.models.embedder import BatchEmbedder
    from echoseal_torch.models.robust import RobustEmbedder, RobustVerifier
    from echoseal_torch.utils import channels

    fs = 48_000
    n = int(seconds * fs)
    rng = np.random.default_rng(0)
    t = np.arange(n) / fs

    hosts = {
        "silence": np.zeros(n, np.float32),
        "tone1k@-20dB": (0.1 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32),
        "noise@-40dB": (0.01 * rng.standard_normal(n)).astype(np.float32),
    }
    impairments = {
        "clean": lambda x: x,
        "mp3-128k(sim)": lambda x: channels.codec_sim(x, 128.0),
        "awgn-15dB": lambda x: channels.awgn(x, -15.0),
        "timescale+5%": lambda x: channels.time_scale(x, 1.05),
        "lowpass3.5k": lambda x: channels.lowpass(x, 3500.0),
        "dropout": lambda x: channels.dropout(x, 5.0, 0.5),
        "reverb(6dB,150ms)": lambda x: channels.reverb(
            x, 150.0, direct_to_reverb_db=6.0),
    }

    be = BatchEmbedder(key, device=device)
    report = {}
    for hname, host in hosts.items():
        wm = be.embed(host, session_nonce=b"capcheck")
        tx2 = RobustEmbedder(key)
        wm2 = tx2.process(host.copy())
        det = WatermarkDetector(key, list_size=16, device=device)
        rv = RobustVerifier(key, device=device)
        row = {}
        for iname, f in impairments.items():
            det.session_nonce = None
            rv.session_nonce = None
            try:
                compat = bool(det.verify(f(wm.copy()), fs))
            except Exception as e:  # noqa: BLE001 -- the grid records it
                compat = f"ERROR: {e}"
            try:
                v2 = bool(rv.verify(f(wm2.copy()), fs))
            except Exception as e:  # noqa: BLE001 -- the grid records it
                v2 = f"ERROR: {e}"
            row[iname] = {"compat": compat, "v2": v2}
        report[hname] = row
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    import argparse

    from echoseal_torch.diagnostics import device_arg, device_of

    ap = argparse.ArgumentParser(
        description="Measured capability envelope: accept rates across "
                    "hosts x impairments (JSON to stdout).")
    ap.add_argument("--seconds", type=float, default=4.0)
    device_arg(ap)
    args = ap.parse_args()
    main(seconds=args.seconds, device=device_of(args))
