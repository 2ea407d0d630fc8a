"""Robust (v2) waveform: host designs of the receiver, and the host TX.

Same crypto, frame layout (63/128/1024 chips), hop schedule, payload
format and mixing law as the compat path, but each chip is HELD for
``profile.oversample`` samples before the band-pass, and the polar info set
follows the standard convention (``echoseal_tpu/models/robust.py``).  The
receiver demodulates by least squares against the oversampled forward
model (``robust_demod_matrix``) after syncing on the oversampled preamble
(``robust_templates``); the batch verifier is
``models/pipeline.py::RobustBatchVerifier``.
"""
from __future__ import annotations

import secrets
from functools import lru_cache

import numpy as np
import scipy.linalg as sla
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
