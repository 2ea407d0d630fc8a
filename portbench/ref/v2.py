"""Frozen copy of the port's v2 (robust) receiver designs: the sync
templates and the LS chip-recovery matrices, designed in float64."""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import scipy.linalg as sla
from scipy.signal import lfilter

from . import filters
from .bandplan import BAND_PLAN
from .params import FRAME_LEN
from .sequences import bits_to_bpsk, mls63

# LS regularisation ladder for the oversampled model: the in-band energy
# concentration makes conditioning mild, so two profiles suffice
LAM_PROFILES = (1e-6, 1e-3)


@lru_cache(maxsize=32)
def _chip_pulse(lo: float, hi: float, fs: int, S: int, span: int) -> np.ndarray:
    """Zero-state filtered S-sample box pulse, length ``span``."""
    b, a = filters.butter_coeffs(lo, hi, fs)
    box = np.zeros(span)
    box[:S] = 1.0
    return lfilter(b, a, box)


@lru_cache(maxsize=32)
def robust_demod_matrix(lo: float, hi: float, fs: int, S: int,
                        lam: float) -> np.ndarray:
    """(FRAME_LEN, span) float32 LS chip-recovery matrix (float64 design)."""
    span = FRAME_LEN * S
    g = _chip_pulse(lo, hi, fs, S, span)
    T = np.zeros((span, FRAME_LEN))
    for j in range(FRAME_LEN):
        T[j * S:, j] = g[:span - j * S]
    A = T.T @ T + lam * np.eye(FRAME_LEN)
    M = sla.cho_solve(sla.cho_factor(A), T.T)
    return M.astype(np.float32)


@lru_cache(maxsize=8)
def robust_templates(fs: int, S: int) -> np.ndarray:
    """(4, 63*S) unit-norm sync templates (filtered oversampled MLS)."""
    pre = np.repeat(bits_to_bpsk(mls63(), dtype=np.float64), S)
    out = []
    for lo, hi in BAND_PLAN:
        b, a = filters.butter_coeffs(lo, hi, fs)
        t = lfilter(b, a, pre)
        out.append((t / (np.linalg.norm(t) + 1e-12)).astype(np.float32))
    return np.stack(out)
