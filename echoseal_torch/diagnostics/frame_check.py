"""Frame-level TX->RX diagnostic: chip BER / alignment / header per band.

Synthesises one frame per band with a frozen payload, runs the
single-clip scan stage on it (the detector's device tables, on
``device``), and prints what the demodulator saw -- the quickest way to
localise a wire-format or demod regression.
"""
from __future__ import annotations

import numpy as np


def main(key: bytes = b"\xaa" * 32, device=None) -> None:
    import torch

    from echoseal_torch.core.params import FRAME_LEN, HDR_L, PRE_L
    from echoseal_torch.core.sequences import bits_to_bpsk
    from echoseal_torch.models import detector as D
    from echoseal_torch.models.embedder import WatermarkEmbedder
    from echoseal_torch.ops.polar import encode_np

    tx = WatermarkEmbedder(key)
    det = D.WatermarkDetector(key, list_size=8, device=device)

    print(f"{'ctr':>4} {'band':>12} {'BER':>8} {'pre':>6} "
          f"{'hdr_ok':>6} {'lo16':>6}")
    ctr = 0
    seen_bands: set[int] = set()
    while len(seen_bands) < 4 and ctr < 64:
        b = det._hop.index(ctr)
        if b in seen_bands:
            ctr += 1
            continue
        seen_bands.add(b)
        tx.frame_ctr = ctr
        payload = tx._build_payload()
        tx._build_payload = lambda p=payload: p
        frame = tx._make_frame_chips()
        del tx._build_payload

        cw = encode_np(payload)
        pn = tx.sec.pn_bits(ctr, FRAME_LEN)[PRE_L + HDR_L :]
        expect = bits_to_bpsk(cw) * bits_to_bpsk(pn)

        T = frame.size
        Tpad = D._pad_bucket(max(T, FRAME_LEN + D.demod.W_CASCADE))
        x = np.zeros(Tpad, np.float32)
        x[:T] = frame
        out = {k: v.cpu().numpy() for k, v in D._scan_stage(
            torch.as_tensor(x, device=det.device), T, det.tables).items()}

        chips = out["chips_d"][b, 0, 0]
        seg = chips[PRE_L + HDR_L :]
        ber = float(np.mean(np.sign(seg) != expect))
        print(f"{ctr:>4} {str(det._hop.band(ctr)):>12} {ber:>8.4f} "
              f"{out['pre_d'][b, 0, 0]:>6.3f} "
              f"{str(bool(out['hdr_ok_d'][b, 0, 0])):>6} "
              f"{int(out['hdr_lo16_d'][b, 0, 0]):>6}")
        ctr += 1


if __name__ == "__main__":
    import argparse

    from echoseal_torch.diagnostics import device_arg, device_of

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    main(device=device_of(ap.parse_args()))
