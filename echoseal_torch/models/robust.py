"""Robust (v2) waveform: receiver designs, time-scale scan, and the host TX.

Same crypto, frame layout (63/128/1024 chips), hop schedule, payload
format and mixing law as the compat path, but each chip is HELD for
``profile.oversample`` samples before the band-pass, and the polar info set
follows the standard convention (``echoseal_tpu/models/robust.py``).  The
receiver demodulates by least squares against the oversampled forward
model (``robust_demod_matrix``) after syncing on the oversampled preamble
(``robust_templates``); the batch verifier is
``models/pipeline.py::RobustBatchVerifier``.  Its time-scale recovery
uses the scaled-template scan (``scaled_template_bank``,
``_scale_scan_batch``) and the inter-peak spacing estimator
(``estimate_timescale_from_peaks``) below.
"""
from __future__ import annotations

import secrets
from functools import lru_cache

import numpy as np
import scipy.linalg as sla
import torch
from scipy.signal import lfilter

from echoseal_torch.core.bandplan import BAND_PLAN, hop_schedule
from echoseal_torch.core.crypto import SecureChannel
from echoseal_torch.core.params import (
    EPS,
    FRAME_LEN,
    HDR_L,
    MAGIC,
    MIX_HEADROOM,
    PRE_L,
    TxParams,
)
from echoseal_torch.core.profiles import ROBUST, WaveformProfile, profile_spec
from echoseal_torch.core.sequences import bits_to_bpsk, header_bits, mls63
from echoseal_torch.models.embedder import db_to_lin
from echoseal_torch.ops import filters
from echoseal_torch.ops.polar import encode_np
from echoseal_torch.ops.resample import resample_to

MIN_CLIP_SECONDS = 3.0
# LS regularisation ladder for the oversampled model: the in-band energy
# concentration makes conditioning mild, so two profiles suffice
LAM_PROFILES = (1e-6, 1e-3)


# --------------------------------------------------------------- host model
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


# -------------------------------------------------- time-scale recovery
# The 504-sample (S=8) preamble loses sync coherence past ~0.25% residual
# time scale, so an UNKNOWN +-5% playback-speed change hides the watermark
# completely.  Recovery is a sync-only scaled-template scan: one bank of
# preamble templates, each resampled for a candidate correction factor
# (grid step 0.33% keeps the worst-case residual ~0.17%, inside coherence)
# x 4 bands, correlated against the clip by FFT.  The winning factor is
# refined by the inter-peak spacing estimator (frame spacing = span /
# factor, ~5e-5 resolution) and ONE corrective resample makes the frame
# coherent for the normal pipeline.
SCALE_SCAN_GRID = tuple(np.round(np.linspace(0.95, 1.05, 31), 5))


@lru_cache(maxsize=8)
def scaled_template_bank(fs: int, S: int,
                         factors: tuple = SCALE_SCAN_GRID) -> np.ndarray:
    """(len(factors)*4, Lmax) zero-padded unit-norm scaled sync templates.

    Row ``i*4 + b`` = band-``b`` template as it appears after a playback
    at channel factor ``1/factors[i]`` (i.e. the clip that CORRECTION
    factor ``factors[i]`` would fix).
    """
    base = robust_templates(fs, S).astype(np.float64)
    rows = []
    for r in factors:
        for b in range(4):
            t = resample_to(fs, base[b], int(round(fs / r)))
            rows.append(t / (np.linalg.norm(t) + 1e-12))
    L = max(t.size for t in rows)
    bank = np.zeros((len(rows), L), np.float32)
    for i, t in enumerate(rows):
        bank[i, : t.size] = t
    return bank


@torch.no_grad()
def _scale_scan_stage(x: torch.Tensor, n_valid, bank: torch.Tensor
                      ) -> torch.Tensor:
    """Max normalized sync correlation per bank row for ONE clip -> (rows,)."""
    nv = torch.as_tensor(n_valid, device=x.device).reshape(1)
    return _scale_scan_batch(x[None], nv, bank)[0]


@torch.no_grad()
def _scale_scan_batch(x: torch.Tensor, n_valid: torch.Tensor,
                      bank: torch.Tensor, row_chunk: int = 4) -> torch.Tensor:
    """Max normalized sync correlation per clip and bank row: (B, T) -> (B, R).

    FFT correlation, not conv: the bank has ~124 rows, and one rfft of the
    batch plus per-row spectral products is far cheaper than a 124-kernel
    convolution.  The sliding window energy is a cumsum difference, O(T).
    Bank rows go in chunks of ``row_chunk`` so the (B, chunk, T)
    correlation cube stays bounded (~380 MB at B=128, chunk=4, T=184k)
    instead of the full (B, 124, T).  Lags whose window would pass
    ``n_valid`` are masked, which also masks the circular wrap-around.
    """
    B, T = x.shape
    R, L = bank.shape
    n_lag = T - L + 1
    X = torch.fft.rfft(x)                            # (B, T//2+1)
    e = torch.cumsum(x * x, dim=-1)
    ew = e[:, L - 1:].clone()
    ew[:, 1:] -= e[:, :-L]
    energy = torch.sqrt(torch.clamp(ew, min=0.0)) + 1e-12   # (B, n_lag)
    del e, ew
    lag = torch.arange(n_lag, device=x.device)
    bad = lag[None, :] > (n_valid.to(torch.int64)[:, None] - L)  # (B, n_lag)
    Bf = torch.conj(torch.fft.rfft(bank, T))         # (R, T//2+1)
    scores = []
    for r0 in range(0, R, row_chunk):
        corr = torch.fft.irfft(X[:, None, :] * Bf[None, r0:r0 + row_chunk],
                               T, dim=-1)[..., :n_lag]
        corr.div_(energy[:, None, :])
        corr.masked_fill_(bad[:, None, :], float("-inf"))
        scores.append(corr.amax(dim=-1))             # (B, chunk)
    return torch.cat(scores, dim=1)


# Minimum |fine - 1| at which a chained refinement acts on the spacing
# estimate.  For true playback factor s the best RETRY_UP=12000 rational
# can sit up to ~4e-5 off 1/s, and the SCAN grid pick up to a full lattice
# step (~8.3e-5) off -- e.g. s=1.031: grid 0.97 leaves residual +7.0e-5
# while the ADJACENT lattice point 11639/12000 leaves -1.6e-5.  A larger
# threshold (1e-4) masks that quantization and loses the clips whose start
# phase cannot tolerate ~7e-5 of chip drift.  2.5e-5 sits just above the
# spacing estimator's per-clip noise floor (~1e-5: sample-quantized
# spacings at k>=4 frame baselines, median over >=2 ratios), so near-zero
# residuals rarely spawn spurious retries, while every masked lattice
# residual is actionable; retries are deduped on the lattice and bounded
# by the refinement depth.
FINE_CHAIN_MIN = 2.5e-5


def estimate_timescale_from_peaks(peaks: np.ndarray | None,
                                  span: int) -> float | None:
    """Modal scale ratio from same-band sync-peak spacings.

    Observed frame spacing d = k * span / residual_factor; a >=2-frame
    baseline pins the residual to ~5e-5 -- well inside the demod window's
    ~2e-4 chip-coherence limit.  ``peaks``: (4, K) sample positions, -1 for
    invalid.  Returns None when fewer than 2 plausible spacings exist.
    """
    if peaks is None:
        return None
    ratios = []
    for b in range(peaks.shape[0]):
        pos = np.sort(peaks[b][peaks[b] >= 0])
        for d in np.diff(pos):
            k = int(round(d / span))
            if k >= 1 and abs(d / (k * span) - 1.0) < 0.06:
                ratios.append(d / (k * span))
    if len(ratios) < 2:
        return None
    return float(np.median(ratios))


# ------------------------------------------------------------------ TX side
class RobustEmbedder:
    """Streaming v2 watermark mixer (same ``process`` surface as compat).

    ``rng`` (a ``numpy.random.Generator``), when given, draws every random
    byte -- the session nonce, each frame's plaintext pad and its AEAD
    nonce, in that order per frame -- so the output is reproducible test
    data.  Without it they come from ``secrets``.
    """

    def __init__(self, key32: bytes, params: TxParams | None = None,
                 profile: WaveformProfile = ROBUST, *,
                 rng: np.random.Generator | None = None) -> None:
        self.p = params or TxParams()
        self.profile = profile
        self.sec = SecureChannel(key32)
        self._hop = hop_schedule(key32)
        self._spec = profile_spec(profile)
        self._rng = rng
        self.frame_ctr = 0
        self._chip_buf = np.empty(0, dtype=np.float32)
        self._session_nonce = self._bytes(8)
        self._preamble_sy = bits_to_bpsk(self.p.preamble)
        self._hdr_pn_sy = bits_to_bpsk(self.sec.pn_bits(0, HDR_L))

    def _bytes(self, n: int) -> bytes:
        return secrets.token_bytes(n) if self._rng is None else self._rng.bytes(n)

    def process(self, samples: np.ndarray) -> np.ndarray:
        x = np.asarray(samples).astype(np.float32, copy=False)
        in_rms = float(np.sqrt(np.mean(x * x)) + EPS) if x.size else EPS
        while self._chip_buf.size < x.size:
            self._chip_buf = np.concatenate(
                (self._chip_buf, self._make_frame()))
            self.frame_ctr = (self.frame_ctr + 1) % (2**32)
        chips = self._chip_buf[: x.size]
        self._chip_buf = self._chip_buf[x.size :]
        scale = max(db_to_lin(self.p.target_rel_db) * in_rms,
                    db_to_lin(self.p.floor_rel_dbfs))
        headroom = max(MIX_HEADROOM - float(np.max(np.abs(x), initial=0.0)),
                       0.0)
        peak = float(np.max(np.abs(chips), initial=0.0)) + EPS
        scale = min(scale, headroom / peak) if peak > 0.0 else 0.0
        return x + chips * scale

    def _make_frame(self) -> np.ndarray:
        S = self.profile.oversample
        ctr = self.frame_ctr
        band = self._hop.band(ctr)
        # sealed blob = AEAD nonce(12) + meta + tag(16) lands exactly on the
        # spec's payload width: 11 random-pad bytes at K=448, 0 at K=360
        pad = self._spec.info_len // 8 - 28 - 16
        meta = (MAGIC + ctr.to_bytes(4, "big") + self._session_nonce
                + self._bytes(pad))
        payload = self.sec.seal_many([meta], [self._bytes(12)])[0]
        data_sy = bits_to_bpsk(encode_np(payload, self._spec))
        hdr_sy = bits_to_bpsk(header_bits(ctr)) * self._hdr_pn_sy
        pn = self.sec.pn_bits(ctr, FRAME_LEN)[PRE_L + HDR_L :]
        spread = data_sy * bits_to_bpsk(pn)
        sym = np.concatenate([self._preamble_sy, hdr_sy, spread])
        up = np.repeat(sym.astype(np.float64), S)
        b, a = filters.butter_coeffs(band[0], band[1], self.p.fs)
        chips = lfilter(b, a, up)
        peak = float(np.max(np.abs(chips))) + EPS
        if peak > 3.0:
            chips = chips / peak
        return chips.astype(np.float32)
