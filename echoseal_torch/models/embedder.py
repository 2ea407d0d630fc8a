"""Watermark transmitter, host side (numpy).

The streaming mixer (``WatermarkEmbedder.process``) and the reference-exact
frame synthesis of ``echoseal_tpu/models/embedder.py``: per-frame seal ->
polar encode -> BPSK -> counter header -> PN spread -> zero-state
Butterworth band-pass -> peak guard, mixed at an RMS-proportional level
with an absolute floor and a clip-headroom limiter.  ``frames_np`` seals
and synthesises a whole batch of frames (one AEAD keystream pass, one AES
pass for the PN).  Frame parity is pinned by the golden vectors
``frame_0/5/1000`` (tests/golden/reference_vectors.npz).
"""
from __future__ import annotations

import secrets

import numpy as np
from scipy.signal import lfilter

from echoseal_torch.core.bandplan import BAND_PLAN, hop_schedule
from echoseal_torch.core.crypto import SecureChannel
from echoseal_torch.core.params import (
    EPS,
    FRAME_LEN,
    FRAME_PEAK_GUARD,
    HDR_L,
    MIX_HEADROOM,
    PRE_L,
    TxParams,
)
from echoseal_torch.core.sequences import bits_to_bpsk, header_bits, mls63
from echoseal_torch.ops import filters
from echoseal_torch.ops.polar import encode_np, polar_spec


def db_to_lin(db: float) -> float:
    return 10.0 ** (db / 20.0)


def _plaintext(frame_ctr: int, session_nonce: bytes,
               pad: bytes | None = None) -> bytes:
    """27-byte frame plaintext: magic | ctr | session nonce | 11 random."""
    return (b"ESAL" + int(frame_ctr).to_bytes(4, "big") + session_nonce
            + (pad if pad is not None else secrets.token_bytes(11)))


class WatermarkEmbedder:
    """Streaming watermark mixer (reference WatermarkEmbedder surface)."""

    def __init__(self, key32: bytes, params: TxParams | None = None) -> None:
        self.p = params or TxParams()
        self.sec = SecureChannel(key32)
        self._hop = hop_schedule(key32)
        self.frame_ctr = 0
        self._chip_buf = np.empty(0, dtype=np.float32)
        self._session_nonce = secrets.token_bytes(8)
        self._spec = polar_spec(self.p.N, self.p.K)
        self._preamble_sy = bits_to_bpsk(self.p.preamble)
        # header PN is counter-independent: always the frame-0 stream
        self._hdr_pn_sy = bits_to_bpsk(self.sec.pn_bits(0, HDR_L))

    # ------------------------------------------------------------------ API
    def process(self, samples: np.ndarray) -> np.ndarray:
        """Mix watermark chips into ``samples`` (reference embedder.py:44-75).

        Level = max(host_rms * 10^(target_rel_db/20), floor) capped so the
        mix never exceeds MIX_HEADROOM peak.
        """
        x = np.asarray(samples).astype(np.float32, copy=False)
        in_rms = float(np.sqrt(np.mean(x * x)) + EPS) if x.size else EPS

        needed = x.size
        while self._chip_buf.size < needed:
            self._chip_buf = np.concatenate(
                (self._chip_buf, self._make_frame_chips())
            )
            self.frame_ctr = (self.frame_ctr + 1) % (2**32)

        chips = self._chip_buf[:needed]
        self._chip_buf = self._chip_buf[needed:]

        scale = max(
            db_to_lin(self.p.target_rel_db) * in_rms,
            db_to_lin(self.p.floor_rel_dbfs),
        )
        headroom = max(MIX_HEADROOM - float(np.max(np.abs(x), initial=0.0)), 0.0)
        peak = float(np.max(np.abs(chips), initial=0.0)) + EPS
        scale = min(scale, headroom / peak) if peak > 0.0 else 0.0
        return x + chips * scale

    # ------------------------------------------------------------ internals
    def _build_payload(self) -> bytes:
        """Seal the 27-byte plaintext -> 55-byte blob (embedder.py:153-168)."""
        blob = self.sec.seal(_plaintext(self.frame_ctr, self._session_nonce))
        assert len(blob) == 55
        return blob

    def _make_frame_chips(self) -> np.ndarray:
        """One 1215-chip watermark frame for the current counter."""
        return synthesize_frame_np(
            self.sec, self._hop, self.frame_ctr, self._build_payload(),
            fs=self.p.fs, preamble_sy=self._preamble_sy,
            hdr_pn_sy=self._hdr_pn_sy, spec=self._spec)


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
    if rng is None:
        nonce = session_nonce or secrets.token_bytes(8)
        blobs = sec.seal_many([_plaintext(int(c), nonce) for c in ctrs])
    else:
        nonce = session_nonce or rng.bytes(8)
        blobs = sec.seal_many(
            [_plaintext(int(c), nonce, rng.bytes(11)) for c in ctrs],
            [rng.bytes(12) for _ in ctrs])
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
