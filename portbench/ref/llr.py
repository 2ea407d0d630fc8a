"""Frozen copy of the port's plain payload decode: PN gather, LLR, hard
polar decode and CRC-8 in torch operations."""
from __future__ import annotations

import torch

from .params import HDR_L, PRE_L
from .polar import PolarSpec, hard_decode_batch

CLIP = 16.0
PAYLOAD_OFF = PRE_L + HDR_L


def payload_llr_plain(chips: torch.Tensor, pn_sy: torch.Tensor) -> torch.Tensor:
    """(..., 1215) chips x (..., 1024) +-1 PN -> (..., 1024) LLRs (torch ops)."""
    z = chips[..., PAYLOAD_OFF:] * pn_sy
    power = torch.mean(z * z, dim=-1, keepdim=True) + 1e-20
    zn = z * torch.rsqrt(power)
    amp = torch.clamp(torch.mean(torch.abs(zn), dim=-1, keepdim=True),
                      0.05, 1.0)
    sigma2 = torch.clamp(1.0 - amp * amp, min=0.05)
    return torch.clamp(2.0 * amp * zn / sigma2, -CLIP, CLIP)


def payload_decode_plain(chips: torch.Tensor, pn_bits: torch.Tensor,
                         pn_row: torch.Tensor, spec: PolarSpec,
                         want_llr: bool = False):
    """The PN gather, ``payload_llr_plain`` and ``hard_decode_batch``.

    ``chips`` (..., 1215), in the precision the LLRs are computed in;
    ``pn_bits`` an (M, 1024) {0,1} table;
    ``pn_row`` (...,) the table row of each chip row, clamped to
    [0, M - 1] as ``jnp.take`` does.  Returns (LLRs (..., 1024) or
    None unless ``want_llr``, info bits (..., info_len) int32, crc_ok
    (...,) bool).
    """
    idx = torch.clamp(pn_row.long(), 0, pn_bits.shape[0] - 1)
    llr = payload_llr_plain(chips, 2.0 * pn_bits[idx].to(chips.dtype) - 1.0)
    info, crc_ok = hard_decode_batch(llr, spec)
    return (llr if want_llr else None), info, crc_ok
