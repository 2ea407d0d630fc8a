"""Frozen copy of ``echoseal_torch/core/bandplan.py`` for the benchmark's traffic and
plain reference (it does not move with the program).

Ultrasonic band plan and the keyed frequency-hop schedule.

Four sub-bands in 4-22 kHz; the per-frame band choice is
``HMAC-SHA256(key, pack(">I", frame_ctr))[0] % 4`` (reference utils.py:19-36).

Note the reference keys the hop schedule with the *raw master key* (its
``SecureChannel`` never defines a ``band_key`` attribute, so the
``getattr(self.sec, "band_key", key32)`` fallback always fires --
embedder.py:33, detector.py:31).  We reproduce that wire behaviour.
"""
from __future__ import annotations

import hmac
import struct
from functools import lru_cache

import numpy as np

BAND_PLAN: tuple[tuple[int, int], ...] = (
    (4_000, 6_000),    # mid
    (8_000, 10_000),   # upper-mid
    (16_000, 18_000),  # hi-1
    (18_000, 22_000),  # hi-2
)
NUM_BANDS = len(BAND_PLAN)


def band_index(key: bytes, frame_ctr: int) -> int:
    """Keyed hop-schedule index into BAND_PLAN for one frame counter."""
    digest = hmac.new(key, struct.pack(">I", frame_ctr & 0xFFFFFFFF), "sha256")
    return digest.digest()[0] % NUM_BANDS


def choose_band(key: bytes, frame_ctr: int) -> tuple[int, int]:
    """(lo, hi) Hz band for one frame counter."""
    return BAND_PLAN[band_index(key, frame_ctr)]


class HopSchedule:
    """Cached hop schedule for a key: vectorised band lookup over counters.

    The detector enumerates candidate counters in windows of up to +-200
    around a time estimate (detector.py:122-142); caching the HMAC-derived
    band index per counter makes those windows a single table lookup.
    """

    def __init__(self, key: bytes) -> None:
        self._key = key
        self._cache: dict[int, int] = {}

    def index(self, frame_ctr: int) -> int:
        idx = self._cache.get(frame_ctr)
        if idx is None:
            idx = band_index(self._key, frame_ctr)
            self._cache[frame_ctr] = idx
        return idx

    def band(self, frame_ctr: int) -> tuple[int, int]:
        return BAND_PLAN[self.index(frame_ctr)]

    def indices(self, frame_ctrs: np.ndarray) -> np.ndarray:
        """Band index for an array of counters (int64 in, int64 out)."""
        return np.array([self.index(int(c)) for c in np.ravel(frame_ctrs)],
                        dtype=np.int64)

    def counters_in_band(self, lo: int, hi: int, band_idx: int) -> np.ndarray:
        """All counters in [lo, hi) whose hop lands in ``band_idx``."""
        ctrs = np.arange(max(0, lo), hi, dtype=np.int64)
        mask = self.indices(ctrs) == band_idx
        return ctrs[mask]


@lru_cache(maxsize=32)
def hop_schedule(key: bytes) -> HopSchedule:
    return HopSchedule(key)
