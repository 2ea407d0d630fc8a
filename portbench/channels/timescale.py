"""A playback at another speed: ``{"kind": "timescale", "factor": f}``
plays the stream ``f`` times as fast (1.031: 3.1 % fast), by scipy's
float64 polyphase ``resample_poly(x, 1000, round(1000 * f))``; the
stream keeps its sample rate, so it is ``f`` times shorter."""
from __future__ import annotations

from math import gcd

import numpy as np
from scipy.signal import resample_poly


def ratio(spec: dict) -> tuple[int, int]:
    """(up, down) of the channel's resample, reduced."""
    up, down = 1000, int(round(1000 * spec["factor"]))
    g = gcd(up, down)
    return up // g, down // g


def apply(x: np.ndarray, spec: dict, fs: int, rng: np.random.Generator
          ) -> tuple[np.ndarray, int]:
    up, down = ratio(spec)
    return resample_poly(x.astype(np.float64), up, down), fs
