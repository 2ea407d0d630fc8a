"""Channel impairments for tests and the chip smoke (numpy, host side).

Only what makes impaired clips for the batch tier so far:

* ``awgn``        -- additive white noise at a target SNR
* ``time_scale``  -- +-x% playback-speed change (polyphase resample)

Both equal ``echoseal_tpu/utils/channels.py``'s.  They model the world
outside the device, so they are host transforms.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import resample_poly


def awgn(x: np.ndarray, snr_db: float, rng=None) -> np.ndarray:
    """Additive white Gaussian noise at ``snr_db`` relative to signal power."""
    rng = rng or np.random.default_rng(0)
    p_sig = float(np.mean(x * x)) + 1e-30
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    return (x + rng.standard_normal(x.size) * np.sqrt(p_noise)).astype(
        np.float32)


def time_scale(x: np.ndarray, factor: float, fs: int = 48_000) -> np.ndarray:
    """Playback-speed change by ``factor`` (1.05 = 5% fast)."""
    up, down = 1000, int(round(1000 * factor))
    return resample_poly(x, up, down).astype(np.float32)
