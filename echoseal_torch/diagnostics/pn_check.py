"""PN keystream + hop schedule audit (host only).

Checks the determinism contracts the whole system rests on: per-counter
PN streams are reproducible, differ across counters, the header PN is the
counter-0 stream, the hop schedule is keyed and balanced across the four
bands, and the golden vectors (when present) still match.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def main(key: bytes = b"\xaa" * 32) -> None:
    from echoseal_torch.core.bandplan import hop_schedule
    from echoseal_torch.core.crypto import SecureChannel
    from echoseal_torch.core.params import FRAME_LEN, HDR_L

    sec = SecureChannel(key)
    hop = hop_schedule(key)

    a = sec.pn_bits(7, FRAME_LEN)
    b = sec.pn_bits(7, FRAME_LEN)
    print("pn determinism:", "OK" if np.array_equal(a, b) else "FAIL")

    ctrs = np.arange(256)
    streams = sec.pn_bits_batch(ctrs, FRAME_LEN)
    dists = [np.mean(streams[i] != streams[j])
             for i in range(8) for j in range(i + 1, 8)]
    print(f"cross-counter distance: min={min(dists):.3f} (expect ~0.5)")

    hdr = sec.pn_bits(0, HDR_L)
    print("header PN == ctr-0 prefix:",
          "OK" if np.array_equal(hdr, streams[0][:HDR_L]) else "FAIL")

    bands = hop.indices(np.arange(4096))
    counts = np.bincount(bands, minlength=4)
    print("hop balance over 4096 ctrs:", counts.tolist(),
          "(expect ~1024 each)")

    gold_path = (Path(__file__).parents[2] / "tests" / "golden"
                 / "reference_vectors.npz")
    if gold_path.exists():
        gold = np.load(gold_path)
        ok = all(np.array_equal(sec.pn_bits(c, 1215), gold[f"pn_{c}"])
                 for c in (0, 1, 255, 1024, 65537))
        print("golden PN parity:", "OK" if ok else "FAIL")


if __name__ == "__main__":
    main()
