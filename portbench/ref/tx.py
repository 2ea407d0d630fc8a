"""Frozen copy of the port's host transmitters, for the benchmark's traffic.

``frames_np`` (compat frames, sealed and synthesised on the host) and
``RobustEmbedder`` (the v2 streaming mixer) as ``echoseal_torch`` had them
when the benchmark was defined, so that a later change to the program's
TX cannot move the benchmark's inputs.  Wire-identical: the frames match
``tests/golden/reference_vectors.npz`` (``portbench/tests``).
"""
from __future__ import annotations

import secrets

import numpy as np
from scipy.signal import lfilter

from . import filters
from .bandplan import BAND_PLAN, hop_schedule
from .crypto import SecureChannel
from .params import (
    EPS,
    FRAME_LEN,
    FRAME_PEAK_GUARD,
    HDR_L,
    MAGIC,
    MIX_HEADROOM,
    PRE_L,
    TxParams,
)
from .polar import encode_np, polar_spec
from .profiles import ROBUST, WaveformProfile, profile_spec
from .sequences import bits_to_bpsk, header_bits, mls63


def db_to_lin(db: float) -> float:
    return 10.0 ** (db / 20.0)


def _plaintext(frame_ctr: int, session_nonce: bytes,
               pad: bytes | None = None) -> bytes:
    """27-byte frame plaintext: magic | ctr | session nonce | 11 random."""
    return (b"ESAL" + int(frame_ctr).to_bytes(4, "big") + session_nonce
            + (pad if pad is not None else secrets.token_bytes(11)))


# ----------------------------------------------------------- host synthesis
def _frame_chips(band, frame_ctr: int, payload: bytes,
                 pn_payload_bits: np.ndarray, preamble_sy: np.ndarray,
                 hdr_pn_sy: np.ndarray, spec, fs: int) -> np.ndarray:
    """Chips of one frame from its band, payload and payload PN bits."""
    data_sy = bits_to_bpsk(encode_np(payload, spec))
    hdr_sy = bits_to_bpsk(header_bits(frame_ctr)) * hdr_pn_sy
    spread = data_sy * bits_to_bpsk(pn_payload_bits)

    b, a = filters.butter_coeffs(band[0], band[1], fs)
    zi0 = np.zeros(max(len(a), len(b)) - 1, dtype=np.float64)
    y_pre, zi1 = lfilter(b, a, preamble_sy, zi=zi0)
    y_rest, _ = lfilter(b, a, np.concatenate((hdr_sy, spread)), zi=zi1)
    chips = np.concatenate((y_pre, y_rest))

    peak = float(np.max(np.abs(chips))) + EPS
    if peak > FRAME_PEAK_GUARD:
        chips = chips / peak
    return chips.astype(np.float32)


def synthesize_frame_np(
    sec: SecureChannel,
    hop,
    frame_ctr: int,
    payload: bytes,
    *,
    fs: int = 48_000,
    preamble_sy: np.ndarray | None = None,
    hdr_pn_sy: np.ndarray | None = None,
    spec=None,
) -> np.ndarray:
    """Reference-exact single-frame synthesis (embedder.py:78-151).

    scipy ``lfilter`` runs in float64 (matching the reference's dtype
    promotion) and the result is cast to float32 at the end.
    """
    if preamble_sy is None:
        preamble_sy = bits_to_bpsk(mls63())
    if hdr_pn_sy is None:
        hdr_pn_sy = bits_to_bpsk(sec.pn_bits(0, HDR_L))
    pn = sec.pn_bits(frame_ctr, FRAME_LEN)[PRE_L + HDR_L:]
    return _frame_chips(hop.band(frame_ctr), frame_ctr, payload, pn,
                        preamble_sy, hdr_pn_sy, spec or polar_spec(), fs)


def _seal_frames(sec: SecureChannel, ctrs: np.ndarray,
                 session_nonce: bytes | None,
                 rng: np.random.Generator | None) -> list[bytes]:
    """One sealed 55-byte payload per counter, under one session nonce.

    Without ``rng`` the random bytes come from ``secrets``; with it the
    generator draws, in this order, the session nonce (when not given),
    every frame's 11 pad bytes, then every frame's 12-byte AEAD nonce.
    """
    if rng is None:
        nonce = session_nonce or secrets.token_bytes(8)
        return sec.seal_many([_plaintext(int(c), nonce) for c in ctrs])
    nonce = session_nonce or rng.bytes(8)
    return sec.seal_many(
        [_plaintext(int(c), nonce, rng.bytes(11)) for c in ctrs],
        [rng.bytes(12) for _ in ctrs])


def frames_np(sec: SecureChannel, hop, ctrs: np.ndarray,
              session_nonce: bytes | None = None, *,
              fs: int = 48_000,
              rng: np.random.Generator | None = None) -> np.ndarray:
    """(len(ctrs), FRAME_LEN) float32 frames, sealed and synthesised on the host.

    Every frame carries a fresh sealed payload for its counter under one
    session nonce (random when not given), like ``WatermarkEmbedder``.
    ``rng``, when given, draws every random byte (session nonce, plaintext
    padding, AEAD nonces) so the frames are reproducible test data.
    """
    ctrs = np.asarray(ctrs, dtype=np.int64).ravel()
    blobs = _seal_frames(sec, ctrs, session_nonce, rng)
    pn = sec.pn_bits_batch(ctrs, FRAME_LEN)[:, PRE_L + HDR_L:]
    bands = hop.indices(ctrs)
    pre_sy = bits_to_bpsk(mls63())
    hdr_pn_sy = bits_to_bpsk(sec.pn_bits(0, HDR_L))
    spec = polar_spec()
    out = np.empty((ctrs.size, FRAME_LEN), dtype=np.float32)
    for i, c in enumerate(ctrs):
        out[i] = _frame_chips(BAND_PLAN[bands[i]], int(c), blobs[i], pn[i],
                              pre_sy, hdr_pn_sy, spec, fs)
    return out


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

    def embed(self, host: np.ndarray,
              session_nonce: bytes | None = None) -> np.ndarray:
        if session_nonce is not None:
            self._session_nonce = session_nonce
        return self.process(host)

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
