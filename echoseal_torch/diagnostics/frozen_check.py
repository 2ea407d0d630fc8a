"""Frozen-set / info-set audit: TX and RX polar conventions must agree.

For both shipped profiles this checks:

* the info set matches the declared convention -- COMPAT keeps the
  inverted set of the original wire format (information on the least
  reliable channels of the ascending 3GPP table, kept bit-exact for wire
  parity), while the v2 ROBUST profile uses the standard last-K (most
  reliable) convention;
* a random payload round-trips through encode -> hard decode under each
  spec on ``device`` (catches a drifted CRC matrix or data_pos
  permutation, which the set-membership checks alone would not).

Exit code 0 = every check passed.
"""
from __future__ import annotations

import numpy as np


def audit(verbose: bool = True, device=None) -> bool:
    """Run the audit; the hard decode runs on ``device`` (None = CUDA)."""
    import torch

    from echoseal_torch.core.device import resolve_device
    from echoseal_torch.core.profiles import COMPAT, ROBUST, profile_spec
    from echoseal_torch.data.q1024 import reliability_sequence
    from echoseal_torch.ops.polar import (
        crc8_bits,
        hard_decode_batch,
        polar_transform_np,
    )

    dev = resolve_device(device)
    ok = True
    for profile in (COMPAT, ROBUST):
        spec = profile_spec(profile)
        rel = reliability_sequence(spec.N)
        want = np.sort(rel[: spec.K] if not profile.standard_info_set
                       else rel[-spec.K:])
        info_pos = np.flatnonzero(~spec.frozen)
        conv = ("standard last-K (most reliable)"
                if profile.standard_info_set
                else "reference-inverted first-K (least reliable)")
        match = np.array_equal(info_pos, want)
        ok &= match
        # encode -> hard-decode round trip on the same spec (TX and RX
        # build their specs through one lru-cached constructor, so
        # agreement is structural; this catches a regression inside it)
        rng = np.random.default_rng(0xA5)
        info = rng.integers(0, 2, spec.info_len).astype(np.uint8)
        data = np.concatenate([info, crc8_bits(info)])
        u = np.zeros(spec.N, dtype=np.uint8)
        u[spec.data_pos] = data
        x = polar_transform_np(u[None])[0]
        llr = torch.as_tensor(
            (2.0 * (2.0 * x - 1.0))[None].astype(np.float32), device=dev)
        bits, crc_ok = hard_decode_batch(llr, spec)
        rt = bool(crc_ok.cpu().numpy()[0]) and np.array_equal(
            bits.cpu().numpy()[0], info)
        ok &= rt
        if verbose:
            print(f"profile {profile.name!r}: N={spec.N} K={spec.K} "
                  f"crc={spec.crc_size}")
            print(f"  convention: {conv}")
            print(f"  info positions (first 10): {info_pos[:10]}")
            print(f"  info positions (last 10):  {info_pos[-10:]}")
            print(f"  set matches convention: {match}")
            print(f"  encode->decode round trip: {rt}")
    if verbose:
        print("AUDIT", "PASS" if ok else "FAIL")
    return bool(ok)


def main(device=None) -> int:
    return 0 if audit(device=device) else 1


if __name__ == "__main__":
    import argparse

    from echoseal_torch.diagnostics import device_arg, device_of

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    raise SystemExit(main(device=device_of(ap.parse_args())))
