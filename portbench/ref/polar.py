"""Frozen copy of ``echoseal_torch/ops/polar.py`` for the benchmark's traffic and
plain reference (it does not move with the program).

Polar(N, K) code structure: frozen sets, CRC-8, encoder, hard decoder.

The code is CRC-aided: the K = info + 8 "data" bits occupy the K most
reliable synthesized channels of the 3GPP reliability ordering (most->least
convention: the first K table entries are the information set, matching
rtwm/fastpolar.py:220-227).  CRC-8 uses poly 0x07, init 0, no final XOR --
a purely *linear* map over GF(2), so the CRC of a batch of candidate
bit-vectors is one matmul mod 2.

The polar transform (encode butterfly) is its own inverse over GF(2); the
hard-decision "fast path" of the list decoder is therefore: threshold the
LLRs, run the same butterfly, read the data positions, check CRC
(fastpolar.py:261-276) -- all trivially batched.  Host helpers work on
numpy arrays, the batched decoder on torch tensors of any device; a
spec's tables go to each device once (``device_tables``).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .params import CRC_SIZE, K_DEFAULT, N_DEFAULT
from .q1024 import reliability_sequence

CRC_POLY = 0x07


# ------------------------------------------------------------------- CRC-8
def crc8_bits(bits: np.ndarray) -> np.ndarray:
    """Bitwise CRC-8 (poly 0x07) of a {0,1} bit vector -> 8 bits MSB-first."""
    reg = 0
    for bit in np.asarray(bits).astype(np.uint8):
        reg ^= (int(bit) & 1) << 7
        reg = ((reg << 1) ^ CRC_POLY) & 0xFF if reg & 0x80 else (reg << 1) & 0xFF
    return np.unpackbits(np.array([reg], dtype=np.uint8))


@lru_cache(maxsize=8)
def crc8_matrix(n_bits: int) -> np.ndarray:
    """(n_bits, 8) GF(2) generator matrix: crc(v) == (v @ M) % 2."""
    m = np.zeros((n_bits, 8), dtype=np.int32)
    for i in range(n_bits):
        e = np.zeros(n_bits, dtype=np.uint8)
        e[i] = 1
        m[i] = crc8_bits(e)
    return m


def crc8_check_batch(info_bits: torch.Tensor, crc_bits: torch.Tensor,
                     crc_mat: np.ndarray | torch.Tensor) -> torch.Tensor:
    """Vectorised CRC check: (..., info) x (..., 8) -> (...,) bool.

    The GF(2) product runs in float32 (CUDA has no integer matmul); every
    partial sum is an integer of at most ``info`` (440), which float32
    holds exactly, so the mod-2 result is exact.  ``crc_mat`` given as
    ``device_tables(spec, device).crc_mat`` is used as it is; a numpy
    matrix is uploaded on every call.
    """
    mat = torch.as_tensor(crc_mat, dtype=torch.float32,
                          device=info_bits.device)
    calc = torch.remainder(info_bits.to(torch.float32) @ mat, 2.0)
    return torch.all(calc == crc_bits.to(torch.float32), dim=-1)


# ----------------------------------------------------------- code structure
@dataclass(frozen=True, eq=False)
class PolarSpec:
    """Static structure of a Polar(N, K) CRC-aided code."""

    N: int
    K: int
    crc_size: int
    frozen: np.ndarray       # (N,) bool, True = frozen
    data_pos: np.ndarray     # (K,) int64 indices of data (info+crc) bits
    crc_mat: np.ndarray      # (K - crc_size, 8) GF(2) CRC generator

    @property
    def info_len(self) -> int:
        return self.K - self.crc_size


@dataclass(frozen=True)
class SpecTables:
    """A spec's tables on one device (``device_tables``)."""

    data_pos: torch.Tensor   # (K,) int64
    crc_mat: torch.Tensor    # (info_len, 8) float32
    # payload_decode's: the data index of each code position (info bits
    # first, then the CRC bits; -1 = frozen), and the CRC-8 of each info
    # bit alone as one byte, bit c = column c of ``crc_mat``
    role: torch.Tensor       # (N,) int16
    crc_cols: torch.Tensor   # (info_len,) uint8


@lru_cache(maxsize=32)
def device_tables(spec: PolarSpec, device: torch.device) -> SpecTables:
    """``spec``'s tables on ``device``, uploaded on the first call only.

    The cache keys on the spec object and the device, so a later call
    returns the same tensors and copies nothing to the device.
    """
    role = np.full(spec.N, -1, dtype=np.int16)
    role[spec.data_pos] = np.arange(spec.K)
    cols = spec.crc_mat.astype(np.uint8) << np.arange(8, dtype=np.uint8)
    return SpecTables(
        data_pos=torch.as_tensor(spec.data_pos, dtype=torch.int64,
                                 device=device),
        crc_mat=torch.as_tensor(spec.crc_mat, dtype=torch.float32,
                                device=device),
        role=torch.as_tensor(role, device=device),
        crc_cols=torch.as_tensor(np.bitwise_or.reduce(cols, axis=1),
                                 device=device))


@lru_cache(maxsize=8)
def polar_spec(N: int = N_DEFAULT, K: int = K_DEFAULT,
               crc_size: int = CRC_SIZE) -> PolarSpec:
    if N <= 0 or (N & (N - 1)) != 0:
        raise ValueError("N must be a positive power of 2")
    if not 0 < K <= N:
        raise ValueError("need 0 < K <= N")
    if not 0 < crc_size < K:
        raise ValueError("need 0 < crc_size < K")
    rel = reliability_sequence(N)
    frozen = np.ones(N, dtype=bool)
    frozen[rel[:K]] = False
    data_pos = np.flatnonzero(~frozen)
    return PolarSpec(N=N, K=K, crc_size=crc_size, frozen=frozen,
                     data_pos=data_pos, crc_mat=crc8_matrix(K - crc_size))


# -------------------------------------------------------------- transform
def polar_transform_np(u: np.ndarray) -> np.ndarray:
    """GF(2) butterfly x = u G_N on the host (last axis = code axis)."""
    x = np.asarray(u, dtype=np.uint8).copy()
    N = x.shape[-1]
    n = int(np.log2(N))
    for s in range(n):
        half = 1 << s
        y = x.reshape(x.shape[:-1] + (N // (2 * half), 2, half))
        y[..., 0, :] ^= y[..., 1, :]
        x = y.reshape(x.shape)
    return x


def polar_transform(u: torch.Tensor) -> torch.Tensor:
    """GF(2) butterfly on a tensor (int dtype, last axis = code axis)."""
    x = u.clone()
    N = x.shape[-1]
    lead = x.shape[:-1]
    for s in range(int(np.log2(N))):
        half = 1 << s
        y = x.view(lead + (N // (2 * half), 2, half))
        y[..., 0, :] ^= y[..., 1, :]
    return x


# ------------------------------------------------------------------ encode
def encode_np(payload: bytes, spec: PolarSpec | None = None) -> np.ndarray:
    """Host encoder: payload bytes -> (N,) uint8 codeword bits."""
    spec = spec or polar_spec()
    if len(payload) * 8 != spec.info_len:
        raise ValueError(f"payload must be {spec.info_len // 8} bytes")
    info = np.unpackbits(np.frombuffer(payload, dtype=np.uint8))
    data = np.concatenate([info, crc8_bits(info)])
    u = np.zeros(spec.N, dtype=np.uint8)
    u[spec.data_pos] = data
    return polar_transform_np(u)


def encode_batch(info_bits: torch.Tensor, spec: PolarSpec) -> torch.Tensor:
    """Batched encoder: (..., info_len) {0,1} -> (..., N) int32 codeword bits.

    The CRC is the mod-2 product with ``spec.crc_mat``, in float32 like
    ``crc8_check_batch`` (exact: every sum is an integer of at most 440).
    """
    info = info_bits.to(torch.int32)
    tabs = device_tables(spec, info.device)
    crc = torch.remainder(info.to(torch.float32) @ tabs.crc_mat,
                          2.0).to(torch.int32)
    u = torch.zeros(info.shape[:-1] + (spec.N,), dtype=torch.int32,
                    device=info.device)
    u[..., tabs.data_pos] = torch.cat([info, crc], dim=-1)
    return polar_transform(u)


# ------------------------------------------------- hard-decision fast path
def hard_decode_batch(llr: torch.Tensor, spec: PolarSpec):
    """Batched hard decode: (..., N) LLR (positive => bit 1).

    Returns (info_bits (..., info_len) int32, crc_ok (...,) bool).
    """
    tabs = device_tables(spec, llr.device)
    hard = (llr > 0.0).to(torch.int32)
    u_hat = polar_transform(hard)
    data = u_hat[..., tabs.data_pos]
    info = data[..., : spec.info_len]
    crc = data[..., spec.info_len:]
    ok = crc8_check_batch(info, crc, tabs.crc_mat)
    # the all-zero word is a valid codeword with CRC 0, so silent/garbage
    # windows would "pass" -- real payloads are AEAD blobs, never all-zero
    ok = ok & torch.any(info != 0, dim=-1)
    return info, ok


def pack_info_bits(info_bits: np.ndarray) -> bytes:
    """(info_len,) {0,1} -> payload bytes."""
    return np.packbits(np.asarray(info_bits, dtype=np.uint8)).tobytes()
