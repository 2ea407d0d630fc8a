"""Watermark transmitter: host synthesis (numpy) and batch synthesis (torch).

The streaming mixer (``WatermarkEmbedder.process``) and the reference-exact
frame synthesis of ``echoseal_tpu/models/embedder.py``: per-frame seal ->
polar encode -> BPSK -> counter header -> PN spread -> zero-state
Butterworth band-pass -> peak guard, mixed at an RMS-proportional level
with an absolute floor and a clip-headroom limiter.  ``frames_np`` seals
and synthesises a whole batch of frames on the host (one AEAD keystream
pass, one AES pass for the PN).  ``BatchEmbedder`` does the crypto on the
host and everything after it on its device
(``synthesize_frames_device``).  Frame parity is pinned by the golden
vectors ``frame_0/5/1000`` (tests/golden/reference_vectors.npz).
"""
from __future__ import annotations

import secrets

import numpy as np
import torch
from scipy.signal import lfilter

from echoseal_torch.core.bandplan import BAND_PLAN, hop_schedule
from echoseal_torch.core.crypto import SecureChannel
from echoseal_torch.core.device import resolve_device
from echoseal_torch.core.params import (
    EPS,
    FRAME_LEN,
    FRAME_PEAK_GUARD,
    HDR_L,
    MIX_HEADROOM,
    PRE_L,
    TxParams,
)
from echoseal_torch.core.sequences import (
    bits_to_bpsk,
    header_bits,
    header_bits_batch,
    mls63,
)
from echoseal_torch.ops import demod, filters
from echoseal_torch.ops.polar import encode_batch, encode_np, polar_spec


def db_to_lin(db: float) -> float:
    return 10.0 ** (db / 20.0)


def _plaintext(frame_ctr: int, session_nonce: bytes,
               pad: bytes | None = None) -> bytes:
    """27-byte frame plaintext: magic | ctr | session nonce | 11 random."""
    return (b"ESAL" + int(frame_ctr).to_bytes(4, "big") + session_nonce
            + (pad if pad is not None else secrets.token_bytes(11)))


class WatermarkEmbedder:
    """Streaming watermark mixer (reference WatermarkEmbedder surface).

    ``rng`` (a ``numpy.random.Generator``), when given, draws every random
    byte -- the session nonce, then each frame's plaintext pad and its AEAD
    nonce -- so the output is reproducible test data.  Without it they
    come from ``secrets``.
    """

    def __init__(self, key32: bytes, params: TxParams | None = None, *,
                 rng: np.random.Generator | None = None) -> None:
        self.p = params or TxParams()
        self.sec = SecureChannel(key32)
        self._hop = hop_schedule(key32)
        self._rng = rng
        self.frame_ctr = 0
        self._chip_buf = np.empty(0, dtype=np.float32)
        self._session_nonce = (secrets.token_bytes(8) if rng is None
                               else rng.bytes(8))
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
        blob = _seal_frames(self.sec, [self.frame_ctr], self._session_nonce,
                            self._rng)[0]
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


# ---------------------------------------------------------- batch synthesis
@torch.no_grad()
def synthesize_frames_device(
    info_bits: torch.Tensor,
    hdr_bits: torch.Tensor,
    pn_payload_bits: torch.Tensor,
    hdr_pn_sy: torch.Tensor,
    preamble_sy: torch.Tensor,
    band_idx: torch.Tensor,
    t_fwd: torch.Tensor,
    spec=None,
) -> torch.Tensor:
    """Batched TX on tensors: (B, ...) inputs -> (B, FRAME_LEN) float32 chips.

    Args:
      info_bits:       (B, 440) {0,1} payload info bits (pre-CRC).
      hdr_bits:        (B, 128) expanded header bits.
      pn_payload_bits: (B, 1024) per-frame payload PN bits.
      hdr_pn_sy:       (128,) +-1 header PN symbols (frame-0 stream).
      preamble_sy:     (63,) +-1 preamble symbols.
      band_idx:        (B,) hop band of each frame, 0..3.
      t_fwd:           (4, FRAME_LEN, FRAME_LEN) float32 forward models
                       (``demod.all_forward_matrices``).

    The polar encode is a GF(2) butterfly over the whole batch.  A frame
    is band-pass filtered from zero state over exactly FRAME_LEN chips, so
    the IIR pass equals the product with the band's lower-triangular
    Toeplitz matrix of the filter's first FRAME_LEN impulse-response
    samples: one float32 matmul per band present in the batch, in place of
    the JAX package's 1215-step biquad scan (``filters.sos_apply`` there;
    here that recursion is kept as the general stateful filter only).
    Products must be true float32 (TF32 off).  Crypto (seal, PN, HMAC hop)
    happens on the host before this call.
    """
    spec = spec or polar_spec()
    B = info_bits.shape[0]
    data_sy = 2.0 * encode_batch(info_bits, spec).to(torch.float32) - 1.0
    pn_sy = 2.0 * pn_payload_bits.to(torch.float32) - 1.0
    hdr_sy = (2.0 * hdr_bits.to(torch.float32) - 1.0) * hdr_pn_sy[None, :]
    symbols = torch.cat([preamble_sy[None, :].expand(B, PRE_L), hdr_sy,
                         data_sy * pn_sy], dim=-1)          # (B, 1215)
    chips = torch.empty_like(symbols)
    for b in range(t_fwd.shape[0]):
        rows = torch.nonzero(band_idx == b)[:, 0]
        if rows.numel():
            chips[rows] = symbols[rows] @ t_fwd[b].T
    peak = torch.amax(torch.abs(chips), dim=-1, keepdim=True) + EPS
    return torch.where(peak > FRAME_PEAK_GUARD, chips / peak, chips)


class BatchEmbedder:
    """Bulk TX: all frames of many counters in one pass on the device.

    The host does the crypto fan-out (seals, PN streams, hop schedule);
    the device does the encode, spreading, band-pass and peak guard.
    ``device=None`` means CUDA and raises without a card; pass
    ``device="cpu"`` for the CPU.  Construction turns TF32 matmuls off.
    """

    def __init__(self, key32: bytes, params: TxParams | None = None, *,
                 device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        self.p = params or TxParams()
        self.sec = SecureChannel(key32)
        self._hop = hop_schedule(key32)
        self._spec = polar_spec(self.p.N, self.p.K)

        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)
        self._preamble_sy = dev(bits_to_bpsk(self.p.preamble))
        self._hdr_pn_sy = dev(bits_to_bpsk(self.sec.pn_bits(0, HDR_L)))
        self._t_fwd = dev(demod.all_forward_matrices(self.p.fs))

    def chip_stream(self, n_samples: int, start_ctr: int = 0,
                    session_nonce: bytes | None = None, *,
                    rng: np.random.Generator | None = None) -> np.ndarray:
        """Watermark chips covering ``n_samples``, frames start_ctr upward."""
        n_frames = -(-n_samples // FRAME_LEN)
        ctrs = np.arange(start_ctr, start_ctr + n_frames, dtype=np.int64)
        chips = self.frames(ctrs, session_nonce=session_nonce,
                            rng=rng).reshape(-1)
        return chips[:n_samples]

    def frames(self, ctrs: np.ndarray, session_nonce: bytes | None = None, *,
               rng: np.random.Generator | None = None) -> np.ndarray:
        """(len(ctrs), FRAME_LEN) float32 frames as a numpy array."""
        return self.frames_device(ctrs, session_nonce, rng=rng).cpu().numpy()

    def frames_device(self, ctrs: np.ndarray,
                      session_nonce: bytes | None = None, *,
                      rng: np.random.Generator | None = None) -> torch.Tensor:
        """Like ``frames`` but the tensor stays on the embedder's device.

        ``rng`` seeds every random byte exactly as in ``frames_np``, so the
        two synthesise the same payloads from equal generators.
        """
        ctrs = np.asarray(ctrs, dtype=np.int64).ravel()
        blobs = _seal_frames(self.sec, ctrs, session_nonce, rng)
        info = np.unpackbits(
            np.frombuffer(b"".join(blobs), dtype=np.uint8).reshape(
                ctrs.size, -1), axis=-1)
        pn = self.sec.pn_bits_batch(ctrs, FRAME_LEN)[:, PRE_L + HDR_L:]

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device)
        return synthesize_frames_device(
            dev(info), dev(header_bits_batch(ctrs)), dev(pn),
            self._hdr_pn_sy, self._preamble_sy,
            dev(self._hop.indices(ctrs)), self._t_fwd, self._spec)

    def embed(self, host: np.ndarray, start_ctr: int = 0,
              session_nonce: bytes | None = None, *,
              rng: np.random.Generator | None = None) -> np.ndarray:
        """Watermark a whole host buffer with the reference mix law applied
        per FRAME_LEN-sized block (matches streaming ``process`` called with
        block == FRAME_LEN).  ``rng`` seeds the random bytes as in
        ``frames``."""
        x = np.asarray(host, dtype=np.float32)
        chips = self.chip_stream(x.size, start_ctr, session_nonce, rng=rng)
        out = np.empty_like(x)
        alpha = db_to_lin(self.p.target_rel_db)
        floor = db_to_lin(self.p.floor_rel_dbfs)
        for i in range(0, x.size, FRAME_LEN):
            xs = x[i : i + FRAME_LEN]
            cs = chips[i : i + FRAME_LEN]
            rms = float(np.sqrt(np.mean(xs * xs)) + EPS)
            scale = max(alpha * rms, floor)
            headroom = max(MIX_HEADROOM - float(np.max(np.abs(xs))), 0.0)
            peak = float(np.max(np.abs(cs))) + EPS
            scale = min(scale, headroom / peak)
            out[i : i + FRAME_LEN] = xs + cs * scale
        return out
