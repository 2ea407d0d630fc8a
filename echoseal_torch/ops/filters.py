"""Band-pass filter design on the host (order-4 Butterworth, utils.py:52-55).

Only the transfer-function design the compat receiver's LS model and the
host TX need; device-side IIR execution is not part of the port yet.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
from scipy.signal import butter

IIR_ORDER = 4  # -> 8th-order transfer function for a band-pass


@lru_cache(maxsize=64)
def butter_coeffs(lo: float, hi: float, fs: int) -> tuple[np.ndarray, np.ndarray]:
    """(b, a) float64 transfer-function coefficients, a[0] == 1."""
    nyq = 0.5 * fs
    b, a = butter(IIR_ORDER, [lo / nyq, hi / nyq], "band")
    return np.asarray(b), np.asarray(a)
