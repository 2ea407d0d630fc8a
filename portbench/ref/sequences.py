"""Frozen copy of ``echoseal_torch/core/sequences.py`` for the benchmark's traffic and
plain reference (it does not move with the program).

Static chip sequences: MLS-63 preamble, header construction helpers.

The 63-chip preamble is a maximal-length sequence from the 6-stage LFSR with
feedback polynomial x^6 + x^5 + 1 (taps 6,5) seeded with 0b111111, emitting
the register LSB each step (reference utils.py:135-145).
"""
from __future__ import annotations

import numpy as np

from .params import HDR_BITS, HDR_REPEAT


def mls63() -> np.ndarray:
    """63-chip maximal-length sequence, uint8 {0,1}."""
    out = np.empty(63, dtype=np.uint8)
    reg = 0b111111
    for i in range(63):
        out[i] = reg & 1
        fb = ((reg >> 5) ^ (reg >> 4)) & 1
        reg = ((reg << 1) | fb) & 0b111111
    return out


def bits_to_bpsk(bits: np.ndarray, dtype=np.float32) -> np.ndarray:
    """{0,1} -> {-1,+1} symbols."""
    return (2.0 * np.asarray(bits).astype(dtype) - 1.0).astype(dtype)


def header_bits(frame_ctr: int) -> np.ndarray:
    """128 header bits: ctr & 0xFFFF MSB-first, each bit repeated 8x."""
    lo16 = frame_ctr & 0xFFFF
    ctr_bytes = np.array([lo16 >> 8, lo16 & 0xFF], dtype=np.uint8)
    return np.repeat(np.unpackbits(ctr_bytes), HDR_REPEAT)


def header_bits_batch(frame_ctrs: np.ndarray) -> np.ndarray:
    """(C, 128) header bits for an array of counters."""
    ctrs = np.asarray(frame_ctrs, dtype=np.int64).ravel()
    lo = (ctrs & 0xFFFF).astype(np.uint16)
    bytes2 = np.stack([(lo >> 8), (lo & 0xFF)], axis=1).astype(np.uint8)
    bits16 = np.unpackbits(bytes2, axis=1)
    assert bits16.shape[1] == HDR_BITS
    return np.repeat(bits16, HDR_REPEAT, axis=1)
