"""Receiver CLI (``echoseal-torch-rx``): verify audio files.

Flags: --key --audio, a --batch mode that verifies many files as one
batch, --monitor for sliding-window verdicts over a long recording, and
--device: ``cuda`` (the default; exits with an error without a card) or
``cpu``.
"""
from __future__ import annotations

import argparse

from echoseal_torch.cli.tx_app import load_key


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="echoseal-torch-rx",
                                description="Verify watermark")
    p.add_argument("--key", required=True,
                   help="256-bit hex key (64 hex chars) or path to keyfile")
    p.add_argument("--audio", nargs="+", help="audio file(s) to check")
    p.add_argument("--list-size", type=int, default=256,
                   help="SCL list size (default 256)")
    p.add_argument("--batch", action="store_true",
                   help="use the batched pipeline (many files, one batch)")
    p.add_argument("--monitor", action="store_true",
                   help="scan a long recording in 4s/2s sliding windows, "
                        "printing a verdict per window (streaming RX)")
    p.add_argument("--profile", choices=("compat", "v2"), default="compat",
                   help="waveform profile: reference-compatible (default) "
                        "or robust v2 (oversampled chips; survives codecs, "
                        "loud hosts, time-scaling)")
    p.add_argument("--payload-k", type=int, default=448, metavar="K",
                   help="v2 payload-rate knob; must match the TX setting "
                        "(see echoseal-torch-tx --payload-k)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the verifier runs (default cuda: an NVIDIA "
                        "GPU must be present)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    key = load_key(args.key)
    if len(key) != 32:
        raise SystemExit("key must be 256-bit (64 hex chars)")

    # "cuda" goes through the port's device rule, which raises a clear
    # error without a card
    device = None if args.device == "cuda" else args.device
    if not args.audio:
        raise SystemExit("no --audio given")
    if args.payload_k != 448:
        if args.profile != "v2":
            raise SystemExit("--payload-k is a v2 knob; the compat wire "
                             "format is fixed at K=448")
        if args.monitor:
            raise SystemExit("--payload-k: the streaming monitor runs at "
                             "the default rate; verify files directly")
    from echoseal_torch.core.profiles import v2_profile

    try:
        profile_v2 = v2_profile(args.payload_k)
    except ValueError as e:      # curated exit, not a traceback
        raise SystemExit(f"--payload-k: {e}")

    from echoseal_torch.io import wavio

    if args.monitor:
        from echoseal_torch.models.detector import resample_to
        from echoseal_torch.models.monitor import BatchStreamMonitor, StreamMonitor

        # build the (expensive: ~378 MB of v2 demod tables) batch verifier
        # ONCE and share it across per-file monitors; honor --list-size
        shared_bv = None
        if args.batch:
            if args.profile == "v2":
                from echoseal_torch.models.pipeline import RobustBatchVerifier

                shared_bv = RobustBatchVerifier(key,
                                                list_size=args.list_size,
                                                device=device)
            else:
                from echoseal_torch.models.pipeline import BatchVerifier

                shared_bv = BatchVerifier(key, device=device)
        rc = 0
        for path in args.audio:
            data, fs = wavio.read(path)
            data = resample_to(48_000, data, fs)
            if args.batch:
                # serving-tier monitor: windows verified in chunked batch
                # dispatches; accepted windows carry ctr/stage detail
                mon = BatchStreamMonitor(key, profile=args.profile,
                                         verifier=shared_bv)
            else:
                mon = StreamMonitor(key, profile=args.profile,
                                    list_size=args.list_size, device=device)
            events = mon.feed(data) + mon.flush()
            file_ok = False
            for ev in events:
                r = ev.result
                extra = (f" ctr={r.frame_ctr} stage={r.stage}"
                         if r.authentic else "")
                print(f"{path} [{ev.t_start:7.2f}s - {ev.t_end:7.2f}s] "
                      f"{'authentic' if r.authentic else '---'}{extra}")
                file_ok |= r.authentic
            rc |= 0 if file_ok else 1
        return rc

    if args.batch and len(args.audio) > 1:
        import numpy as np

        from echoseal_torch.models.detector import resample_to
        from echoseal_torch.models.pipeline import BatchVerifier

        clips, lens = [], []
        for path in args.audio:
            data, fs = wavio.read(path)
            data = resample_to(48_000, data, fs)
            clips.append(data)
            lens.append(data.size)
        T = max(lens)
        # margin pad rounded up to a multiple of 16384, not a power of two
        # (the sync conv runs over every padded sample)
        Tpad = (T + 2 * 16384 - 1) & ~(16384 - 1)
        batch = np.zeros((len(clips), Tpad), dtype=np.float32)
        for i, c in enumerate(clips):
            batch[i, : c.size] = c
        if args.profile == "v2":
            from echoseal_torch.models.pipeline import RobustBatchVerifier

            verdicts = RobustBatchVerifier(
                key, list_size=args.list_size, profile=profile_v2,
                device=device).verify_batch_recover(
                batch, np.asarray(lens, dtype=np.int32))
        else:
            verdicts = BatchVerifier(key, device=device).verify_batch(
                batch, np.asarray(lens, dtype=np.int32))
        rc = 0
        for path, ok in zip(args.audio, verdicts):
            print(f"{path}: {'authentic' if ok else 'tampered / no watermark'}")
            rc |= 0 if ok else 1
        return rc

    if args.profile == "v2":
        from echoseal_torch.models.robust import RobustVerifier

        detector = RobustVerifier(key, list_size=args.list_size,
                                  profile=profile_v2, device=device)
    else:
        from echoseal_torch.models.detector import WatermarkDetector

        detector = WatermarkDetector(key, list_size=args.list_size,
                                     device=device)
    rc = 0
    for path in args.audio:
        data, fs = wavio.read(path)
        ok = detector.verify(data, fs)
        print(f"{path}: {'authentic' if ok else 'tampered / no watermark'}"
              if len(args.audio) > 1 else
              ("authentic" if ok else "tampered / no watermark"))
        rc |= 0 if ok else 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
