"""Live transmitter CLI (``echoseal-torch-tx``).

Flags: --key --device (a sounddevice index) --seconds --save, plus an
offline mode (--infile/--outfile) so the TX engine runs on machines
without an audio stack.  The streaming mixers are host code (numpy, or
the C ring mixer with ``--native``), so this CLI needs no GPU.
``--native`` applies to the compat mixer: with ``--profile v2``, or on a
host without a C compiler, it says so on stderr and mixes in Python.
"""
from __future__ import annotations

import argparse
import sys
import time


def load_key(path_or_hex: str) -> bytes:
    # Only a full 64-char hex string is a literal 256-bit key; anything
    # shorter (incl. 32/48-char hex) falls through to the keyfile path so
    # the error message names the real problem.
    s = path_or_hex.strip()
    if len(s) == 64 and all(c in "0123456789abcdefABCDEF" for c in s):
        return bytes.fromhex(s)
    try:
        with open(s, "rb") as f:
            return f.read()
    except OSError as e:
        raise SystemExit(
            f"--key is neither a 64-char hex string nor a readable "
            f"keyfile: {e}") from e


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="echoseal-torch-tx", description="Real-time watermark transmitter")
    p.add_argument("--key", required=True,
                   help="256-bit hex key (64 hex chars) or path to keyfile")
    p.add_argument("--device", type=int, help="sounddevice index")
    p.add_argument("--seconds", type=float, default=30.0, help="run duration")
    p.add_argument("--save", nargs="?", const="tx_output.wav",
                   help="save first 10 s of output to WAV")
    p.add_argument("--infile", help="offline mode: watermark this WAV file")
    p.add_argument("--outfile", help="offline mode: output WAV path")
    p.add_argument("--profile", choices=("compat", "v2"), default="compat",
                   help="waveform profile to embed (v2 = robust oversampled "
                        "chips, wire-incompatible with the reference)")
    p.add_argument("--payload-k", type=int, default=448, metavar="K",
                   help="v2 payload-rate knob: Polar(1024, K) info+CRC "
                        "bits (default 448 = reference rate; floor 360 = "
                        "the AEAD envelope). Lower K buys AWGN margin "
                        "with payload rate -- the measured frontier is "
                        "benchmarks/awgn_envelope.json rate_axis. TX and "
                        "RX must agree on K.")
    p.add_argument("--native", action="store_true",
                   help="mix in the C ring mixer (lock-free audio callback; "
                        "frames rendered on a feeder thread)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    key = load_key(args.key)
    if len(key) != 32:
        raise SystemExit("key must be 256-bit (64 hex chars)")

    if args.profile == "v2":
        from echoseal_torch.core.profiles import v2_profile
        from echoseal_torch.models.robust import RobustEmbedder

        try:
            profile = v2_profile(args.payload_k)
        except ValueError as e:      # curated exit, not a traceback
            raise SystemExit(f"--payload-k: {e}")
        embedder = RobustEmbedder(key, profile=profile)
    else:
        if args.payload_k != 448:
            raise SystemExit("--payload-k is a v2 knob; the compat wire "
                             "format is fixed at K=448")
        from echoseal_torch.models.embedder import WatermarkEmbedder

        embedder = WatermarkEmbedder(key)
    if args.native and args.profile == "v2":
        print("--native applies to the compat mixer; using Python mixer",
              file=sys.stderr)
    elif args.native:
        from echoseal_torch import native

        if native.available():
            from echoseal_torch.native.stream import NativeStreamEmbedder

            embedder = NativeStreamEmbedder(key)
        else:
            print("--native: no C compiler available, using Python mixer",
                  file=sys.stderr)
    try:
        return _run(args, embedder)
    finally:
        if hasattr(embedder, "close"):      # the native feeder thread
            embedder.close()


def _run(args, embedder) -> int:
    if args.infile:
        from echoseal_torch.io import wavio
        from echoseal_torch.io.audioloop import NullAudioLoop

        host, fs = wavio.read(args.infile)
        if fs != embedder.p.fs:
            raise SystemExit(f"input must be {embedder.p.fs} Hz (got {fs})")
        out = NullAudioLoop(embedder.process, fs=fs,
                            save_path=args.save).run(host)
        outfile = args.outfile or "tx_output.wav"
        wavio.write(outfile, out, fs)
        print(f"watermarked {host.size / fs:.1f}s -> {outfile}",
              file=sys.stderr)
        return 0

    from echoseal_torch.io.audioloop import AudioLoop

    loop = AudioLoop(embedder.process, fs=embedder.p.fs,
                     device=args.device, save_path=args.save)
    loop.start()
    print("live watermarking - speak into mic ...", file=sys.stderr)
    try:
        time.sleep(args.seconds)
    finally:
        loop.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
