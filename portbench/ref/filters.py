"""Frozen copy of ``echoseal_torch/ops/filters.py`` for the benchmark's traffic and
plain reference (it does not move with the program).

Band-pass filtering: host-side Butterworth design, device-side execution.

Design (coefficients, impulse responses, matched-filter taps, correlation
templates) happens once on the host in float64 via SciPy and is cached as
small constants (numpy).  Execution is plain torch on whatever device the
signal lives on:

* ``iir_apply`` / ``sos_apply`` -- exact ``scipy.signal.lfilter`` /
  ``sosfilt`` semantics (direct-form II transposed) as a recursion over
  time, batched over leading axes, with the state in (``zi``) and out
  (``zf``) so segments chain.  One step is a handful of small tensor ops,
  so a long signal costs its length in launches: these are the general,
  stateful filters, not a throughput path.  The batch TX does not use
  them: a frame is filtered from zero state over exactly ``FRAME_LEN``
  chips, which is one product with the band's Toeplitz matrix
  (``models/embedder.py::synthesize_frames_device``).
* ``fir_apply`` -- FFT convolution with a truncated impulse response; an
  approximation of the IIR good to ~1e-6 relative.

Reference behaviour reproduced here: order-4 Butterworth band-pass
(utils.py:52-55); the detector's matched filter is the time-reversed,
99.9%-energy-truncated TX*RX cascade impulse response
(detector.py:260-294); its preamble template is the doubly-filtered MLS
(detector.py:63-69).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from scipy.signal import butter, lfilter

from .bandplan import BAND_PLAN
from .sequences import bits_to_bpsk, mls63

IIR_ORDER = 4  # -> 8th-order transfer function for a band-pass


# ----------------------------------------------------------- host-side design
@lru_cache(maxsize=64)
def butter_coeffs(lo: float, hi: float, fs: int) -> tuple[np.ndarray, np.ndarray]:
    """(b, a) float64 transfer-function coefficients, a[0] == 1."""
    nyq = 0.5 * fs
    b, a = butter(IIR_ORDER, [lo / nyq, hi / nyq], "band")
    return np.asarray(b), np.asarray(a)


@lru_cache(maxsize=64)
def butter_sos(lo: float, hi: float, fs: int) -> np.ndarray:
    """(4, 6) float64 second-order sections of the same band-pass.

    Numerically equivalent to ``butter_coeffs`` but far better conditioned
    in float32: a single-pass float32 cascade tracks the float64 direct
    form to ~1e-6.
    """
    nyq = 0.5 * fs
    return butter(IIR_ORDER, [lo / nyq, hi / nyq], "band", output="sos")


def all_band_sos(fs: int) -> np.ndarray:
    """Stacked (4, 4, 6) float32 SOS for the whole band plan."""
    return np.stack(
        [butter_sos(lo, hi, fs).astype(np.float32) for lo, hi in BAND_PLAN]
    )


@lru_cache(maxsize=64)
def impulse_response(lo: float, hi: float, fs: int, length: int = 256) -> np.ndarray:
    """float64 impulse response of the band filter, ``length`` samples."""
    b, a = butter_coeffs(lo, hi, fs)
    imp = np.zeros(length)
    imp[0] = 1.0
    return lfilter(b, a, imp)


@lru_cache(maxsize=64)
def matched_filter_taps(lo: float, hi: float, fs: int) -> np.ndarray:
    """Matched filter for the TX*RX filter cascade (float32).

    impulse(256) -> TX filter -> self-convolve (RX applies the same band-pass
    again) -> truncate at 99.9% cumulative energy -> time-reverse ->
    unit-energy normalise.  Mirrors detector.py:260-294 so alignment search
    windows land on the same taps.
    """
    g_tx = impulse_response(lo, hi, fs).astype(np.float32)
    g_eff = np.convolve(g_tx, g_tx).astype(np.float32)
    energy = np.cumsum(g_eff * g_eff)
    total = float(energy[-1]) + 1e-20
    idx = int(np.searchsorted(energy, 0.999 * total))
    if idx + 1 < g_eff.size:
        g_eff = g_eff[: idx + 1]
    h = g_eff[::-1].copy()
    h /= np.sqrt(float(np.sum(h * h))) + 1e-12
    return h


@lru_cache(maxsize=64)
def preamble_template(lo: float, hi: float, fs: int) -> np.ndarray:
    """Unit-norm doubly-filtered MLS-63 preamble template (float32)."""
    b, a = butter_coeffs(lo, hi, fs)
    pre_sy = bits_to_bpsk(mls63(), dtype=np.float64)
    tpl = lfilter(b, a, lfilter(b, a, pre_sy))
    tpl = tpl / (np.sqrt(np.sum(tpl * tpl)) + 1e-12)
    return tpl.astype(np.float32)


def all_band_coeffs(fs: int) -> tuple[np.ndarray, np.ndarray]:
    """Stacked (4, 9) float32 b and a coefficients for the whole band plan."""
    bs, ars = [], []
    for lo, hi in BAND_PLAN:
        b, a = butter_coeffs(lo, hi, fs)
        bs.append(b.astype(np.float32))
        ars.append(a.astype(np.float32))
    return np.stack(bs), np.stack(ars)


@lru_cache(maxsize=64)
def fir_from_iir(lo: float, hi: float, fs: int, tol: float = 1e-7) -> np.ndarray:
    """Truncated impulse response approximating the IIR to ``tol`` (float32).

    Tail is cut where the remaining energy fraction drops below ``tol**2``.
    """
    h = impulse_response(lo, hi, fs, length=8192)
    tail = np.sqrt(np.cumsum((h * h)[::-1])[::-1] / (np.sum(h * h) + 1e-30))
    keep = int(np.argmax(tail < tol)) or h.size
    return h[: max(keep, 64)].astype(np.float32)


# ---------------------------------------------------------- device execution
def _like(c, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(c, dtype=x.dtype, device=x.device)


@torch.no_grad()
def iir_apply(b, a, x: torch.Tensor, zi=None):
    """``lfilter(b, a, x, zi)`` on tensors: DF2T recursion over the last axis.

    ``x`` may have arbitrary leading batch axes; ``b``/``a`` may either be
    1-D (shared) or carry matching leading axes (per-batch filters, e.g. the
    4-band filterbank).  Returns (y, zf) with ``zf`` the final state, so
    callers can chain segments exactly like SciPy's ``zi``/``zf``.
    """
    b, a = _like(b, x), _like(a, x)
    order = b.shape[-1] - 1
    batch_shape = x.shape[:-1]
    if zi is None:
        z = x.new_zeros(batch_shape + (order,))
    else:
        z = _like(zi, x).expand(batch_shape + (order,)).clone()
    b0, b_rest, a_rest = b[..., 0], b[..., 1:], a[..., 1:]
    y = torch.empty_like(x)
    for t in range(x.shape[-1]):
        xt = x[..., t]
        yt = b0 * xt + z[..., 0]
        # z_j' = b_{j+1} x + z_{j+1} - a_{j+1} y   (z_order == 0 implicitly)
        z = torch.cat([z[..., 1:], torch.zeros_like(z[..., :1])], dim=-1) \
            + b_rest * xt[..., None] - a_rest * yt[..., None]
        y[..., t] = yt
    return y, z


@torch.no_grad()
def sos_apply(sos, x: torch.Tensor, zi=None):
    """Cascaded-biquad IIR on tensors (scipy ``sosfilt`` semantics).

    ``sos``: (..., S, 6) sections, broadcastable against ``x``'s batch axes.
    ``x``:   (..., T).  Returns (y, zf) with zf shaped (..., S, 2).  Every
    time step runs all S sections; the batch rides the tensor axes.
    """
    sos = _like(sos, x)
    n_sections = sos.shape[-2]
    batch_shape = x.shape[:-1]
    if zi is None:
        z = x.new_zeros(batch_shape + (n_sections, 2))
    else:
        z = _like(zi, x).expand(batch_shape + (n_sections, 2)).clone()
    b0, b1, b2 = sos[..., 0], sos[..., 1], sos[..., 2]
    a1, a2 = sos[..., 4], sos[..., 5]
    z0 = [z[..., s, 0] for s in range(n_sections)]
    z1 = [z[..., s, 1] for s in range(n_sections)]
    y = torch.empty_like(x)
    for t in range(x.shape[-1]):
        v = x[..., t]
        for s in range(n_sections):
            out = b0[..., s] * v + z0[s]
            z0[s] = b1[..., s] * v - a1[..., s] * out + z1[s]
            z1[s] = b2[..., s] * v - a2[..., s] * out
            v = out
        y[..., t] = v
    zf = torch.stack([torch.stack([z0[s], z1[s]], dim=-1)
                      for s in range(n_sections)], dim=-2)
    return y, zf


def fft_convolve_full(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """'full' linear convolution along the last axis via rFFT."""
    n = x.shape[-1] + h.shape[-1] - 1
    nfft = 1 << int(np.ceil(np.log2(max(n, 2))))
    y = torch.fft.irfft(torch.fft.rfft(x, nfft) * torch.fft.rfft(h, nfft),
                        nfft)[..., :n]
    return y.to(x.dtype)


def fir_apply(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Causal FIR filtering (same output length as ``x``) along last axis."""
    return fft_convolve_full(x, h)[..., : x.shape[-1]]
