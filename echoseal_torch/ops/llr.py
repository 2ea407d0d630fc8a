"""Payload LLR: despread recovered chips and normalise into decoder LLRs.

Positive LLR favours bit 1.  No mean subtraction (polar codewords over a
mostly-frozen ``u`` are not balanced, so the despread mean carries signal).
Scaling is the Gaussian-mixture moment estimate: with z ~ +-a + n,
E[z^2] = a^2 + s^2 and E|z| ~= a, so llr = 2 a z / s^2 after unit-power
normalisation (``echoseal_tpu/ops/demod.py::payload_llr``).

``payload_llr`` is the wrapper: for a CUDA tensor it launches the
hand-written kernel ``csrc/payload_llr.cu`` (or raises); it takes the plain
torch version ``payload_llr_plain`` only for tensors on the CPU.

``payload_decode`` is what the verify paths call: the PN gather, these
LLRs and the hard-decision polar decode with its CRC-8 check
(``polar.hard_decode_batch``) in one launch of ``csrc/payload_decode.cu``;
its plain version ``payload_decode_plain`` is that chain in torch ops.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from echoseal_torch.core.params import (
    CRC_SIZE,
    FRAME_LEN,
    HDR_L,
    N_DEFAULT,
    PRE_L,
)
from echoseal_torch.ops import build
from echoseal_torch.ops.polar import (
    PolarSpec,
    device_tables,
    hard_decode_batch,
)

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


# ------------------------------------------------------- fused decode
def payload_decode_plain(chips: torch.Tensor, pn_bits: torch.Tensor,
                         pn_row: torch.Tensor, spec: PolarSpec,
                         want_llr: bool = False):
    """The PN gather, ``payload_llr_plain`` and ``hard_decode_batch``.

    ``chips`` (..., 1215) float32; ``pn_bits`` an (M, 1024) {0,1} table;
    ``pn_row`` (...,) the table row of each chip row, clamped to
    [0, M - 1] as ``jnp.take`` does.  Returns (LLRs (..., 1024) float32 or
    None unless ``want_llr``, info bits (..., info_len) int32, crc_ok
    (...,) bool).
    """
    idx = torch.clamp(pn_row.long(), 0, pn_bits.shape[0] - 1)
    llr = payload_llr_plain(chips, 2.0 * pn_bits[idx].to(torch.float32) - 1.0)
    info, crc_ok = hard_decode_batch(llr, spec)
    return (llr if want_llr else None), info, crc_ok


@lru_cache(maxsize=1)
def _decode_launcher():
    fn = build.load("payload_decode").payload_decode_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def payload_decode(chips: torch.Tensor, pn_bits: torch.Tensor,
                   pn_row: torch.Tensor, spec: PolarSpec, *,
                   want_llr: bool = False):
    """Chips -> (LLRs or None, info bits, crc_ok): ``payload_decode_plain``.

    ``chips`` (..., 1215) float32, ``pn_bits`` (M, 1024) int8 or uint8,
    ``pn_row`` (...,) int32 or int64, all contiguous; ``spec`` a code of
    length 1024 with a CRC-8.  CUDA tensors go through the kernel
    (launched on the current stream, counted in
    ``build.LAUNCHES["payload_decode"]``); CPU tensors through
    ``payload_decode_plain``.  Anything else raises.
    """
    tensors = (chips, pn_bits, pn_row)
    if all(t.device.type == "cpu" for t in tensors):
        return payload_decode_plain(chips, pn_bits, pn_row, spec, want_llr)
    dev = chips.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "payload_decode: tensors on "
            f"{', '.join(str(t.device) for t in tensors)}; need all on one "
            "CUDA device or all on the CPU")
    if chips.dtype != torch.float32 or \
            pn_bits.dtype not in (torch.int8, torch.uint8) or \
            pn_row.dtype not in (torch.int32, torch.int64):
        raise ValueError(
            f"payload_decode: dtypes {chips.dtype}, {pn_bits.dtype}, "
            f"{pn_row.dtype}; need float32 chips, int8/uint8 PN bits and "
            "int32/int64 rows")
    if chips.shape[-1] != FRAME_LEN or pn_bits.ndim != 2 or \
            pn_bits.shape[0] == 0 or pn_bits.shape[1] != N_DEFAULT or \
            pn_row.shape != chips.shape[:-1]:
        raise ValueError(
            f"payload_decode: shapes {tuple(chips.shape)}, "
            f"{tuple(pn_bits.shape)}, {tuple(pn_row.shape)}; need "
            f"(..., {FRAME_LEN}), (M >= 1, {N_DEFAULT}) and (...,)")
    if spec.N != N_DEFAULT or spec.crc_size != CRC_SIZE:
        raise ValueError(f"payload_decode: spec N={spec.N}, crc "
                         f"{spec.crc_size}; need N={N_DEFAULT} and CRC-8")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("payload_decode: inputs must be contiguous")
    n_rows = pn_row.numel()
    if n_rows >= 2 ** 31:
        raise ValueError("payload_decode: more than 2**31 - 1 rows")
    lead = tuple(chips.shape[:-1])
    llr = (torch.empty(lead + (N_DEFAULT,), dtype=torch.float32, device=dev)
           if want_llr else None)
    info = torch.empty(lead + (spec.info_len,), dtype=torch.int32, device=dev)
    ok = torch.empty(lead, dtype=torch.bool, device=dev)
    if n_rows == 0:
        return llr, info, ok
    tabs = device_tables(spec, dev)
    with torch.cuda.device(dev):
        rc = _decode_launcher()(
            chips.data_ptr(), FRAME_LEN, PAYLOAD_OFF, pn_bits.data_ptr(),
            pn_bits.shape[0], pn_row.data_ptr(),
            int(pn_row.dtype == torch.int64), tabs.role.data_ptr(),
            tabs.crc_cols.data_ptr(), spec.info_len,
            None if llr is None else llr.data_ptr(), info.data_ptr(),
            ok.data_ptr(), n_rows, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"payload_decode kernel launch failed: cudaError {rc}")
    build.LAUNCHES["payload_decode"] += 1
    return llr, info, ok
