"""Frozen copy of ``echoseal_torch/core/profiles.py`` for the benchmark's traffic and
plain reference (it does not move with the program).

Waveform profiles: reference-compatible vs robust v2.

``COMPAT`` is the reference wire format (1 chip per sample, polar info set
on the least-reliable channels per the reference's inverted table
indexing).  ``ROBUST`` (v2, wire-incompatible, same API) holds each chip
for ``oversample`` samples before band-pass filtering, concentrating chip
energy in band, and uses the standard 5G info-set convention
(``echoseal_tpu/core/profiles.py``).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from .params import FRAME_LEN
from .q1024 import reliability_sequence
from .polar import PolarSpec, crc8_matrix, polar_spec


@dataclasses.dataclass(frozen=True)
class WaveformProfile:
    name: str
    oversample: int          # samples per chip
    standard_info_set: bool  # True = standard 5G convention
    # payload rate knob (standard convention only): K = info + CRC bits of
    # the Polar(1024, K) code.  Floor: the sealed blob is AEAD nonce(12) +
    # [magic(4) + ctr(4) + session nonce(8)] + tag(16) = 44 bytes, so
    # K >= 44*8 + 8 CRC = 360.
    payload_k: int = 448

    @property
    def frame_chips(self) -> int:
        return FRAME_LEN

    @property
    def span(self) -> int:
        """Frame length in samples."""
        return FRAME_LEN * self.oversample

    def __post_init__(self) -> None:
        if self.payload_k != 448 and not self.standard_info_set:
            raise ValueError("payload_k is a v2 (standard info set) knob; "
                             "the compat wire format is fixed at K=448")
        if not (360 <= self.payload_k <= 1016) or self.payload_k % 8:
            raise ValueError("payload_k must be a multiple of 8 in "
                             "[360, 1016] (AEAD envelope floor 44 bytes "
                             "+ 8 CRC bits)")


COMPAT = WaveformProfile("compat", oversample=1, standard_info_set=False)
ROBUST = WaveformProfile("robust", oversample=8, standard_info_set=True)


def v2_profile(payload_k: int = 448) -> WaveformProfile:
    """ROBUST, optionally at a non-default payload rate (TX and RX agree)."""
    if payload_k == ROBUST.payload_k:
        return ROBUST
    return dataclasses.replace(ROBUST, name=f"robust-k{payload_k}",
                               payload_k=payload_k)


@lru_cache(maxsize=4)
def polar_spec_standard(N: int = 1024, K: int = 448,
                        crc_size: int = 8) -> PolarSpec:
    """PolarSpec with the standard convention: info on the MOST reliable
    channels (last-K of the ascending 3GPP table)."""
    rel = reliability_sequence(N)
    frozen = np.ones(N, dtype=bool)
    frozen[rel[-K:]] = False
    return PolarSpec(N=N, K=K, crc_size=crc_size, frozen=frozen,
                     data_pos=np.flatnonzero(~frozen),
                     crc_mat=crc8_matrix(K - crc_size))


def profile_spec(profile: WaveformProfile) -> PolarSpec:
    return (polar_spec_standard(K=profile.payload_k)
            if profile.standard_info_set else polar_spec())
