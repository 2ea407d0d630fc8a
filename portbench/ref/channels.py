"""Frozen copy of the port's MP3-like codec simulation (``codec_sim``)."""
from __future__ import annotations

import numpy as np


def codec_sim(x: np.ndarray, bitrate_kbps: float = 128.0,
              fs: int = 48_000) -> np.ndarray:
    """MP3-like lossy codec simulation.

    Models the two artefacts that matter to an ultrasonic watermark:
    (1) the encoder's lowpass (~16 kHz at 128 kbps -- kills the 16-18 and
    18-22 kHz hop bands), and (2) spectral quantisation noise scaled to the
    bit budget, applied in 50%-overlap windowed-DFT (MDCT-like) frames.
    """
    n = 1152  # MP3 granule-pair size
    hop = n // 2
    win = np.sin(np.pi * (np.arange(n) + 0.5) / n).astype(np.float64)
    pad = (-(x.size - n) % hop)
    # a lead and a tail hop of zeros: every real output sample then has
    # full two-window overlap, so the 1/norm division below is ~1 where it
    # matters (a single window tail there, norm ~1e-6 at sample 0, would
    # amplify the quantisation noise into an onset transient far above
    # full scale)
    xp = np.concatenate([np.zeros(hop), x.astype(np.float64),
                         np.zeros(pad + n)])
    out = np.zeros_like(xp)
    norm = np.zeros_like(xp)
    # bits per coefficient from the rate budget
    coeffs_per_s = fs  # ~one coeff per sample across overlapped frames
    bits_per_coeff = max(bitrate_kbps * 1000.0 / coeffs_per_s, 0.5)
    q_snr = 10.0 ** (-(6.02 * bits_per_coeff) / 20.0)  # quantiser noise amp
    cutoff_bin = int(16_000 / fs * n)
    rng = np.random.default_rng(1234)
    for i in range(0, xp.size - n + 1, hop):
        seg = xp[i : i + n] * win
        spec = np.fft.rfft(seg)
        mag = np.abs(spec)
        spec = spec + (rng.standard_normal(spec.size)
                       + 1j * rng.standard_normal(spec.size)) * mag * q_snr
        spec[cutoff_bin:] = 0.0
        out[i : i + n] += np.fft.irfft(spec, n) * win
        norm[i : i + n] += win * win
    out = out / np.maximum(norm, 1e-9)
    return out[hop : hop + x.size].astype(np.float32)
