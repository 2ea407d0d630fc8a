"""Payload LLR: despread recovered chips and normalise into decoder LLRs.

Positive LLR favours bit 1.  No mean subtraction (polar codewords over a
mostly-frozen ``u`` are not balanced, so the despread mean carries signal).
Scaling is the Gaussian-mixture moment estimate: with z ~ +-a + n,
E[z^2] = a^2 + s^2 and E|z| ~= a, so llr = 2 a z / s^2 after unit-power
normalisation (``echoseal_tpu/ops/demod.py::payload_llr``).

``payload_llr`` is the wrapper: for a CUDA tensor it launches the
hand-written kernel ``csrc/payload_llr.cu`` (or raises); it takes the plain
torch version ``payload_llr_plain`` only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from echoseal_torch.core.params import FRAME_LEN, HDR_L, N_DEFAULT, PRE_L
from echoseal_torch.ops import build

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


@lru_cache(maxsize=1)
def _launcher():
    fn = build.load("payload_llr").payload_llr_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def payload_llr(chips: torch.Tensor, pn_sy: torch.Tensor) -> torch.Tensor:
    """(..., 1215) float32 chips x (..., 1024) float32 +-1 PN -> LLRs.

    CUDA tensors go through the kernel (launched on the current stream,
    counted in ``build.LAUNCHES["payload_llr"]``); CPU tensors through
    ``payload_llr_plain``.  Any other device, dtype, shape or layout raises.
    """
    if chips.device.type == "cpu" and pn_sy.device.type == "cpu":
        return payload_llr_plain(chips, pn_sy)
    if chips.device.type != "cuda" or pn_sy.device != chips.device:
        raise ValueError(f"payload_llr: tensors on {chips.device} and "
                         f"{pn_sy.device}; need both on one CUDA device "
                         "or both on the CPU")
    if chips.dtype != torch.float32 or pn_sy.dtype != torch.float32:
        raise ValueError("payload_llr: chips and pn_sy must be float32")
    if chips.shape[-1] != FRAME_LEN or \
            pn_sy.shape != chips.shape[:-1] + (N_DEFAULT,):
        raise ValueError(f"payload_llr: shapes {tuple(chips.shape)} and "
                         f"{tuple(pn_sy.shape)}; need (..., {FRAME_LEN}) "
                         f"and (..., {N_DEFAULT})")
    if not (chips.is_contiguous() and pn_sy.is_contiguous()):
        raise ValueError("payload_llr: chips and pn_sy must be contiguous")
    n_rows = chips.numel() // FRAME_LEN
    if n_rows >= 2 ** 31:
        raise ValueError("payload_llr: more than 2**31 - 1 rows")
    out = torch.empty(pn_sy.shape, dtype=torch.float32, device=chips.device)
    if n_rows == 0:
        return out
    with torch.cuda.device(chips.device):
        rc = _launcher()(chips.data_ptr(), FRAME_LEN, PAYLOAD_OFF,
                         pn_sy.data_ptr(), out.data_ptr(), n_rows,
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"payload_llr kernel launch failed: cudaError {rc}")
    build.LAUNCHES["payload_llr"] += 1
    return out
