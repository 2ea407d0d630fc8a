"""Robust (v2) waveform: receiver designs, time-scale scan, host TX, and
the single-clip verifier.

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
(``estimate_timescale_from_peaks``) below.  ``RobustVerifier`` is the
single-clip verifier on the same designs (``_robust_scan``), with the
time-scale recovery ladder of ``verify_detailed``.
"""
from __future__ import annotations

import ctypes
import secrets
from functools import lru_cache

import numpy as np
import scipy.linalg as sla
import torch
import torch.nn.functional as F
from scipy.signal import lfilter

from echoseal_torch.convert import (
    SCAN_TABLE_DTYPES,
    VERIFIER_TABLE_DTYPES,
    tables_from_numpy,
)
from echoseal_torch.core.bandplan import BAND_PLAN, hop_schedule
from echoseal_torch.core.crypto import SecureChannel
from echoseal_torch.core.device import resolve_device
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
from echoseal_torch.models.detector import VerifyResult
from echoseal_torch.models.embedder import db_to_lin
from echoseal_torch.ops import build, demod, filters
from echoseal_torch.ops.llr import payload_decode
from echoseal_torch.ops.polar import encode_np, pack_info_bits
from echoseal_torch.ops.resample import resample_to
from echoseal_torch.ops.scl import scl_decode
from echoseal_torch.utils.logging import Timer, get_logger

_LOG = get_logger("rx.v2")

MIN_CLIP_SECONDS = 3.0
# LS regularisation ladder for the oversampled model: the in-band energy
# concentration makes conditioning mild, so two profiles suffice
LAM_PROFILES = (1e-6, 1e-3)


def resolve_table_dtype(table_dtype: str | None) -> torch.dtype:
    """Storage dtype of the v2 LS demod tables: float32 only.

    ``None`` and ``"f32"`` give ``torch.float32``; anything else raises
    (the JAX package's ``"bf16"`` storage is not ported).
    """
    if table_dtype not in (None, "f32"):
        raise ValueError(f"table_dtype={table_dtype!r}: the port stores "
                         "its v2 tables in float32 only ('f32' or None)")
    return torch.float32


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


# The scan runs overlap-save over segments of SCAN_FFT_LEN samples: each
# gives H = SCAN_FFT_LEN - L + 1 lags of a bank of width L.
# ``csrc/scale_scan.cu`` takes banks of at most SCAN_MAX_L taps (a quarter
# segment; the robust profile's bank has about 63 S / 0.95 = 530 at any
# rate) and SCAN_MAX_ROWS rows.
SCAN_FFT_LEN = 4096
SCAN_MAX_L = SCAN_FFT_LEN // 4
SCAN_MAX_ROWS = 256


def scan_bank_spectra(bank: np.ndarray) -> np.ndarray:
    """(R, SCAN_FFT_LEN/2 + 1) complex64: each bank row's rfft, designed
    in float64 from the stored float32 rows."""
    bank = np.asarray(bank, np.float32).astype(np.float64)
    return np.fft.rfft(bank, SCAN_FFT_LEN, axis=-1).astype(np.complex64)


def device_scan_bank(bank: np.ndarray, device) -> torch.Tensor:
    """The scan bank ``bank`` (``scaled_template_bank``) on ``device``,
    carrying its spectra table (``scan_bank_spectra``) there as its
    ``scan_spectra``: the kernel's scan takes a bank only from here."""
    tables = tables_from_numpy(
        {"scan_bank": bank, "scan_spectra": scan_bank_spectra(bank)},
        device, SCAN_TABLE_DTYPES)
    out = tables["scan_bank"]
    out.scan_spectra = tables["scan_spectra"]
    return out


def _window_energy(x: torch.Tensor, L: int) -> torch.Tensor:
    """(B, T - L + 1) float32: sqrt of each L-sample window's energy, +1e-12.

    A cumsum difference, O(T), summed in float64: a one-row cumsum on a
    CUDA card adds in an order that varies from call to call, and in
    float32 the difference of two clip-long sums turned that into up to
    2e-5 of a score on an H100; in float64 the variation stays far below a
    float32 rounding step.  Cast to float32 after the difference.
    """
    e = torch.cumsum(x.double() ** 2, dim=-1)
    ew = e[:, L - 1:].clone()
    ew[:, 1:] -= e[:, :-L]
    return torch.sqrt(torch.clamp(ew.float(), min=0.0)) + 1e-12


@torch.no_grad()
def _scale_scan_stage(x: torch.Tensor, n_valid, bank: torch.Tensor
                      ) -> torch.Tensor:
    """Max normalized sync correlation per bank row for ONE clip -> (rows,)."""
    nv = torch.as_tensor(n_valid, device=x.device).reshape(1)
    return _scale_scan_batch(x[None], nv, bank)[0]


@torch.no_grad()
def scale_scan_plain(x: torch.Tensor, n_valid: torch.Tensor,
                     bank: torch.Tensor, row_chunk: int = 4) -> torch.Tensor:
    """The scan kernel's function in torch ops, along its segments.

    ``x`` (B, T) float32, ``n_valid`` (B,), ``bank`` (R, L).  Returns (B,
    R): per clip and bank row the max over lags t <= n_valid - L of the
    correlation at t over the window's energy (``_window_energy``); -inf
    without such a lag.  Overlap-save: segment s is ``x[s H : s H + N]``
    (zero past T, N = SCAN_FFT_LEN), its rfft times the row's conjugate
    spectrum (``scan_bank_spectra`` of the bank's rows, designed anew each
    call) inverse-transformed gives lags s H .. s H + H - 1.  Bank rows go
    ``row_chunk`` at a time, so the (B, segments, chunk, N) correlation
    stays bounded.
    """
    B, T = x.shape
    R, L = bank.shape
    n_fft = SCAN_FFT_LEN
    H = n_fft - L + 1
    n_seg = -(-(T - L + 1) // H)
    energy = F.pad(_window_energy(x, L), (0, n_seg * H - (T - L + 1)),
                   value=1.0)
    lim = torch.clamp(n_valid.to(torch.int64), max=T) - L
    bad = torch.arange(n_seg * H, device=x.device)[None, :] > lim[:, None]
    segs = F.pad(x, (0, (n_seg - 1) * H + n_fft - T)).unfold(-1, n_fft, H)
    X = torch.fft.rfft(segs)                         # (B, n_seg, N/2 + 1)
    conj = torch.conj(torch.as_tensor(              # (R, N/2 + 1)
        scan_bank_spectra(bank.cpu().numpy()), device=x.device))
    scores = []
    for r0 in range(0, R, row_chunk):
        rows = conj[None, None, r0:r0 + row_chunk]
        corr = torch.fft.irfft(X[:, :, None] * rows, n_fft,
                               dim=-1)[..., :H]      # (B, n_seg, c, H)
        corr = corr.transpose(1, 2).reshape(B, -1, n_seg * H)
        corr = corr / energy[:, None, :]
        corr.masked_fill_(bad[:, None, :], float("-inf"))
        scores.append(corr.amax(dim=-1))             # (B, chunk)
    return torch.cat(scores, dim=1)


@lru_cache(maxsize=1)
def _scan_launcher():
    fn = build.load("scale_scan").scale_scan_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def _scale_scan_batch(x: torch.Tensor, n_valid: torch.Tensor,
                      bank: torch.Tensor, row_chunk: int = 4) -> torch.Tensor:
    """Max normalized sync correlation per clip and bank row: (B, T) -> (B, R).

    ``scale_scan_plain``'s function.  ``x`` (B, T) float32 with unit stride
    along T, ``n_valid`` (B,) int32 or int64, ``bank`` (R, L) float32 with
    L <= ``SCAN_MAX_L`` and R <= ``SCAN_MAX_ROWS``, T >= L.  CUDA tensors go
    through ``csrc/scale_scan.cu`` (launched on the current stream, counted
    in ``build.LAUNCHES["scale_scan"]``), which writes each (clip, segment)
    pair's row maxima, reduced here over the segments; the window energy
    stays ``_window_energy``'s float64 sums, and the bank has to come from
    ``device_scan_bank``, which puts its spectra table beside it.  CPU
    tensors go through ``scale_scan_plain`` (bank rows ``row_chunk`` at a
    time).  Both refuse the same inputs, and tensors on another device or
    on two; there is no fallback.
    """
    tensors = (x, n_valid, bank)
    on_cpu = all(t.device.type == "cpu" for t in tensors)
    dev = x.device
    if not on_cpu and (dev.type != "cuda" or
                       any(t.device != dev for t in tensors)):
        raise ValueError(
            "scale_scan: tensors on "
            f"{', '.join(str(t.device) for t in tensors)}; need all on one "
            "CUDA device or all on the CPU")
    if x.dtype != torch.float32 or bank.dtype != torch.float32 or \
            n_valid.dtype not in (torch.int32, torch.int64):
        raise ValueError(
            f"scale_scan: dtypes {x.dtype}, {n_valid.dtype}, {bank.dtype}; "
            "need float32 x and bank, int32/int64 n_valid")
    B, T = x.shape if x.ndim == 2 else (-1, -1)
    R, L = bank.shape if bank.ndim == 2 else (-1, -1)
    if x.ndim != 2 or bank.ndim != 2 or n_valid.shape != (B,) or \
            not 1 <= L <= min(T, SCAN_MAX_L) or not 1 <= R <= SCAN_MAX_ROWS:
        raise ValueError(
            f"scale_scan: shapes {tuple(x.shape)}, {tuple(n_valid.shape)}, "
            f"{tuple(bank.shape)}; need (B, T), (B,) and (R, L) with "
            f"1 <= L <= min(T, {SCAN_MAX_L}) and 1 <= R <= {SCAN_MAX_ROWS}")
    if x.stride(-1) != 1 or not n_valid.is_contiguous():
        raise ValueError("scale_scan: x needs unit stride along T, n_valid "
                         "must be contiguous")
    if B >= 2 ** 31 or T >= 2 ** 31:
        raise ValueError("scale_scan: more than 2**31 - 1 rows or samples")
    if on_cpu:
        return scale_scan_plain(x, n_valid, bank, row_chunk)
    spectra = getattr(bank, "scan_spectra", None)
    if spectra is None:
        raise ValueError("scale_scan: the bank carries no spectra table; "
                         "put it on the card with device_scan_bank")
    n_seg = -(-(T - L + 1) // (SCAN_FFT_LEN - L + 1))
    part = torch.empty((B, n_seg, R), dtype=torch.float32, device=dev)
    if B == 0:
        return part.amax(dim=1)
    nv = n_valid.to(torch.int64)
    energy = _window_energy(x, L)
    with torch.cuda.device(dev):
        rc = _scan_launcher()(
            x.data_ptr(), x.stride(0), T, nv.data_ptr(), energy.data_ptr(),
            energy.stride(0), spectra.data_ptr(), R, L, part.data_ptr(), B,
            n_seg, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scale_scan kernel launch failed: cudaError {rc}")
    build.LAUNCHES["scale_scan"] += 1
    return part.amax(dim=1)


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


# ------------------------------------------------------------------ RX side
def host_tables(sec: SecureChannel, fs: int,
                profile: WaveformProfile = ROBUST) -> dict[str, np.ndarray]:
    """Every table the single-clip v2 scan reads, as numpy arrays."""
    S = profile.oversample
    m_stack = np.stack([
        np.stack([robust_demod_matrix(lo, hi, fs, S, lam)
                  for lam in LAM_PROFILES])
        for lo, hi in BAND_PLAN])                       # (4, 2, 1215, span)
    return dict(
        templates=robust_templates(fs, S), m_stack=m_stack,
        pre_sy=bits_to_bpsk(mls63()),
        hdr_pn_sy=bits_to_bpsk(sec.pn_bits(0, HDR_L)))


@torch.no_grad()
def _robust_scan(x: torch.Tensor, n_valid: int,
                 tables: dict[str, torch.Tensor], span: int,
                 peaks: int = 4) -> dict[str, torch.Tensor]:
    """Sync + demod + header for one zero-padded v2 clip.

    ``tables``: ``convert.VERIFIER_TABLE_DTYPES``; ``m_stack`` is
    (4, P, 1215, span).  The sync is float32 here (the batch tier's is
    bf16).
    """
    corr = demod.normalized_xcorr(x, tables["templates"])
    lag = torch.arange(corr.shape[-1], device=x.device)
    corr = corr.masked_fill(lag > int(n_valid) - span, float("-inf"))
    idx, val = demod.topk_nms(corr, peaks, span // 2)        # (4, K)

    win = demod.slice_windows(x, idx, span)                  # (4, K, span)
    win = win * torch.rsqrt(torch.mean(win * win, -1, keepdim=True) + 1e-30)
    chips = demod.ls_demod(win[None], tables["m_stack"])[0]  # (4,P,K,1215)
    pre = demod.preamble_score(chips, tables["pre_sy"])
    hdr_ok, lo16, hdr_score = demod.header_decode(chips, tables["hdr_pn_sy"])
    return dict(peak_idx=idx, peak_val=val, chips=chips, pre=pre,
                hdr_ok=hdr_ok, hdr_lo16=lo16, hdr_score=hdr_score)


class RobustVerifier:
    """Single-clip v2 verifier (same verify surface as WatermarkDetector).

    ``device=None`` means CUDA and raises ``RuntimeError`` without a card;
    pass ``device="cpu"`` to run on the CPU.  Construction turns TF32 off
    for matmuls and cuDNN.
    """

    def __init__(self, key32: bytes, *, fs_target: int | None = None,
                 list_size: int | None = None,
                 profile: WaveformProfile = ROBUST,
                 timescale_grid: tuple[float, ...] | None = None,
                 table_dtype: str | None = None,
                 params=None,
                 device: str | torch.device | None = None) -> None:
        resolve_table_dtype(table_dtype)
        device = resolve_device(device)
        sec = SecureChannel(key32)
        fs = fs_target if fs_target is not None else (
            params.fs_target if params is not None else 48_000)
        self._setup(key32, sec, host_tables(sec, fs, profile), device,
                    fs_target=fs_target, list_size=list_size, profile=profile,
                    timescale_grid=timescale_grid, params=params)

    @classmethod
    def from_tables(cls, key32: bytes, tables: dict[str, np.ndarray], *,
                    device: str | torch.device | None = None, **options):
        """A verifier on given numpy tables (e.g. another verifier's)."""
        self = cls.__new__(cls)
        self._setup(key32, SecureChannel(key32), tables,
                    resolve_device(device), **options)
        return self

    def _setup(self, key32, sec, tables, device, *,
               fs_target: int | None = None, list_size: int | None = None,
               profile: WaveformProfile = ROBUST,
               timescale_grid: tuple[float, ...] | None = None,
               params=None) -> None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # RxParams may supply fs_target / list_size / timescale_grid
        # defaults (explicit kwargs win); the compat detector reads the
        # same container, so one config object drives both tiers
        if params is not None:
            if list_size is None:
                list_size = params.list_size
            if timescale_grid is None and params.timescale_grid:
                timescale_grid = params.timescale_grid
            if fs_target is None:
                fs_target = params.fs_target
        self.profile = profile
        self.fs_target = 48_000 if fs_target is None else fs_target
        self.sec = sec
        self._hop = hop_schedule(key32)
        self._spec = profile_spec(profile)
        self._list_size = 32 if list_size is None else int(list_size)
        self.session_nonce: bytes | None = None
        self.timescale_grid = (1.0,) if timescale_grid is None \
            else timescale_grid
        self.device = device
        self.tables = tables_from_numpy(tables, device, VERIFIER_TABLE_DTYPES)
        self._scan_bank: torch.Tensor | None = None

    def verify(self, audio: np.ndarray, fs_in: int) -> bool:
        return self.verify_detailed(audio, fs_in).authentic

    def verify_detailed(self, audio: np.ndarray, fs_in: int) -> VerifyResult:
        signal = resample_to(self.fs_target, audio, fs_in)
        if signal.size < int(MIN_CLIP_SECONDS * self.fs_target):
            return VerifyResult(False, stage=None)
        res = self._verify_once(signal)
        if res.authentic:
            _LOG.event("verdict", authentic=True, stage=res.stage,
                       tries=res.tries, ctr=res.frame_ctr)
            return res

        # ---- time-scale recovery ladder ---------------------------------
        # The demod window loses chip coherence past ~2e-4 residual scale
        # while sync peaks stay visible to ~2.5e-3, so EVERY coarse
        # correction chains one inter-peak-spacing refinement: coarse gets
        # the peaks to show, the spacing estimator (frame spacing =
        # k*span/residual, ~5e-5 resolution on a >=2-frame baseline) pins
        # the true factor, one more resample verifies.  Coarse candidates,
        # cheapest first: the unscaled clip's own peaks (residual already
        # <~0.25%), the caller grid, then the sync-only scaled-template
        # scan (unknown +-5%, no hint).
        tried = {1.0}
        for factor in self._correction_candidates(signal, res):
            f = round(float(factor), 6)
            if f in tried:
                continue
            tried.add(f)
            r = self._verify_scaled(signal, f)
            if r.authentic:
                _LOG.event("verdict", authentic=True, stage=r.stage,
                           timescale=r.timescale, ctr=r.frame_ctr)
                return r
            fine = self._estimate_timescale(r.peaks)
            if fine is not None and abs(fine - 1.0) > FINE_CHAIN_MIN:
                f2 = round(f * fine, 6)
                if f2 not in tried:
                    tried.add(f2)
                    r = self._verify_scaled(signal, f2)
                    if r.authentic:
                        _LOG.event("verdict", authentic=True, stage=r.stage,
                                   timescale=r.timescale, ctr=r.frame_ctr)
                        return r
        _LOG.event("verdict", authentic=False, tried=sorted(tried))
        return VerifyResult(False, stage=None)

    def _correction_candidates(self, signal: np.ndarray, res0):
        """Lazy coarse correction factors for the recovery ladder."""
        fine0 = self._estimate_timescale(res0.peaks)
        if fine0 is not None and abs(fine0 - 1.0) > FINE_CHAIN_MIN:
            yield fine0
        for f in self.timescale_grid:
            if f != 1.0:
                yield f
        est = self.estimate_scale(signal)
        if est is not None and abs(est - 1.0) > 1e-4:
            yield est

    def _verify_scaled(self, signal: np.ndarray, factor: float) -> VerifyResult:
        sig = resample_to(self.fs_target, signal,
                          int(round(self.fs_target * factor)))
        res = self._verify_once(sig)
        res.timescale = factor
        return res

    def estimate_scale(self, signal: np.ndarray) -> float | None:
        """Sync-only scan: best correction factor in [0.95, 1.05] or None.

        One device pass correlates the clip against the full scaled
        template bank, pinning the playback-speed correction to the grid
        step (~0.33%), inside the preamble's sync-coherence range.  The
        gate is deliberately loose: a false estimate costs one wasted
        verify pass, a missed true one costs the clip.  The bank is
        designed on the host at the first call (seconds) and then stays on
        the device.
        """
        if self._scan_bank is None:
            with Timer("rx.v2.scan_bank"):
                self._scan_bank = device_scan_bank(
                    scaled_template_bank(self.fs_target,
                                         self.profile.oversample),
                    self.device)
        bank = self._scan_bank
        T = signal.size
        Tpad = 1 << max(17, (T + bank.shape[-1] - 1).bit_length())
        x = np.zeros(Tpad, dtype=np.float32)
        x[:T] = signal
        with Timer("rx.v2.scale_scan"):
            score = _scale_scan_stage(
                torch.as_tensor(x, device=self.device), T, bank).cpu().numpy()
        per_factor = score.reshape(len(SCALE_SCAN_GRID), 4).max(axis=1)
        med = np.median(per_factor)
        mad = np.median(np.abs(per_factor - med)) + 1e-9
        best = int(np.argmax(per_factor))
        if per_factor[best] < max(med + 2.0 * 1.4826 * mad, 1.15 * med):
            return None
        return float(SCALE_SCAN_GRID[best])

    def _estimate_timescale(self, peaks: np.ndarray | None) -> float | None:
        return estimate_timescale_from_peaks(peaks, self.profile.span)

    @torch.no_grad()
    def _verify_once(self, signal: np.ndarray) -> VerifyResult:
        dev = self.device
        span = self.profile.span
        T = signal.size
        Tpad = 1 << max(17, (T + span - 1).bit_length())
        x = np.zeros(Tpad, dtype=np.float32)
        x[:T] = signal
        with Timer("rx.v2.scan"):
            dev_out = _robust_scan(torch.as_tensor(x, device=dev), T,
                                   self.tables, span=span)
            # the small arrays the host's candidate construction reads;
            # the chips stay on the device
            out = {k: dev_out[k].cpu().numpy()
                   for k in ("peak_idx", "peak_val", "hdr_ok", "hdr_lo16")}
        peaks = np.where(np.isfinite(out["peak_val"]), out["peak_idx"], -1)

        nb, npf, nk, _ = dev_out["chips"].shape
        rows = []   # (band, prof, k, ctr)
        for b in range(nb):
            for k in range(nk):
                start = int(out["peak_idx"][b, k])
                ctr_est = int(round(start / span))
                for p in range(npf):
                    lo16 = int(out["hdr_lo16"][b, p, k])
                    cands = []
                    if out["hdr_ok"][b, p, k] and self._hop.index(lo16) == b:
                        cands.append(lo16)
                    cands += [c for c in range(max(0, ctr_est - 3),
                                               ctr_est + 4)
                              if self._hop.index(c) == b and c not in cands]
                    for c in cands:
                        rows.append((b, p, k, c))
        if not rows:
            return VerifyResult(False, stage=None, peaks=peaks)

        bands = np.array([r[0] for r in rows])
        profs = np.array([r[1] for r in rows])
        ks = np.array([r[2] for r in rows])
        ctrs = np.array([r[3] for r in rows], dtype=np.int64)

        def accepted(i: int, stage: str, tries: int) -> VerifyResult:
            return VerifyResult(True, frame_ctr=int(ctrs[i]),
                                band=BAND_PLAN[bands[i]],
                                peak_pos=int(out["peak_idx"][bands[i], ks[i]]),
                                stage=stage, tries=tries, peaks=peaks)

        b_, p_, k_ = torch.as_tensor(np.stack([bands, profs, ks]), device=dev)
        chips = dev_out["chips"][b_, p_, k_]
        uniq, inv = np.unique(ctrs, return_inverse=True)
        pn = self.sec.pn_bits_batch(uniq, FRAME_LEN)[:, PRE_L + HDR_L:]
        pn_up = torch.as_tensor(np.ascontiguousarray(pn), device=dev)

        with Timer("rx.v2.llr_hard"):
            llr, info, crc_ok = payload_decode(
                chips, pn_up, torch.as_tensor(inv, device=dev), self._spec,
                want_llr=True)
            hits = torch.nonzero(crc_ok)[:, 0]
            bits = info[hits].to(torch.uint8).cpu().numpy()
        for i, row in zip(hits.tolist(), bits):
            if self._accept(row, int(ctrs[i])):
                return accepted(i, "hard", i + 1)

        # SCL pass over the best rows
        with Timer("rx.v2.scl"):
            quality = torch.mean(torch.abs(llr), dim=-1).cpu().numpy()
            sel = np.argsort(-quality, kind="stable")[:32]
            res = scl_decode(llr[torch.as_tensor(sel, device=dev)],
                             self._spec, self._list_size)
            # (row, list) order, as the paths are opened
            rr, ll = np.nonzero(res["crc_ok"].cpu().numpy())
            bits = res["info_bits"][
                torch.as_tensor(rr, device=dev), torch.as_tensor(ll, device=dev)
            ].to(torch.uint8).cpu().numpy()
        for rloc, row in zip(rr, bits):
            r = int(sel[rloc])
            if self._accept(row, int(ctrs[r])):
                return accepted(r, "scl", int(rloc) + 1)
        return VerifyResult(False, stage=None, peaks=peaks)

    def _accept(self, info_bits: np.ndarray, frame_ctr: int) -> bool:
        blob = pack_info_bits(info_bits)
        with Timer("rx.v2.aead_open"):
            plain, _ = self.sec.open_any_layout(blob)
        if plain is None or not plain.startswith(MAGIC):
            return False
        if int.from_bytes(plain[4:8], "big") != frame_ctr:
            return False
        nonce = plain[8:16]
        if self.session_nonce is None:
            self.session_nonce = nonce
            return True
        return nonce == self.session_nonce
