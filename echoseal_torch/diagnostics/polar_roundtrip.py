"""Polar codec AWGN sweep: BLER for both info-set conventions.

Quantifies the compat wire format's inverted information set (the
ascending 3GPP table indexed from the front, putting information on the
LEAST reliable channels) against the standard convention -- the data
point behind the robust v2 profile.  Decodes with the port's SCL decoder
(``ops/scl.py``) on ``device``.
"""
from __future__ import annotations

import math

import numpy as np


def main(trials: int = 16, list_size: int = 8, device=None) -> None:
    import torch

    from echoseal_torch.core.device import resolve_device
    from echoseal_torch.core.profiles import polar_spec_standard
    from echoseal_torch.ops.polar import (
        crc8_bits,
        polar_spec,
        polar_transform_np,
    )
    from echoseal_torch.ops.scl import scl_decode

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    specs = {
        "reference (inverted)": polar_spec(),
        "standard 5G": polar_spec_standard(),
    }
    print(f"{'convention':>22} {'sigma':>6} {'chipBER':>8} {'BLER':>6}")
    for name, spec in specs.items():
        for sigma in (0.3, 0.5, 0.7, 0.9):
            llrs, infos = [], []
            for _ in range(trials):
                info = rng.integers(0, 2, spec.info_len).astype(np.uint8)
                data = np.concatenate([info, crc8_bits(info)])
                u = np.zeros(spec.N, dtype=np.uint8)
                u[spec.data_pos] = data
                x = polar_transform_np(u[None])[0]
                y = (2.0 * x - 1.0) + sigma * rng.standard_normal(spec.N)
                llrs.append((2.0 * y / sigma**2).astype(np.float32))
                infos.append(info)
            res = scl_decode(torch.as_tensor(np.stack(llrs), device=dev),
                             spec, list_size)
            ok = res["crc_ok"].cpu().numpy()
            bits = res["info_bits"].cpu().numpy()
            n_ok = sum(
                any(np.array_equal(bits[i, li], infos[i])
                    for li in np.flatnonzero(ok[i]))
                for i in range(trials))
            ber = 1 - 0.5 * (1 + math.erf(1 / (sigma * 2**0.5)))
            print(f"{name:>22} {sigma:>6.2f} {ber:>8.4f} "
                  f"{1 - n_ok / trials:>6.2f}")


if __name__ == "__main__":
    import argparse

    from echoseal_torch.diagnostics import device_arg, device_of

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=16)
    ap.add_argument("--list-size", type=int, default=8)
    device_arg(ap)
    args = ap.parse_args()
    main(trials=args.trials, list_size=args.list_size, device=device_of(args))
