"""Batched multi-clip verification -- the serving pipelines in torch.

The counterpart of ``echoseal_tpu/models/pipeline.py``'s two batch tiers.

Compat (``_batch_verify_stage`` + ``BatchVerifier``):

* All per-key randomness is precomputed once into device tables: the PN
  payload keystream for every frame counter below ``max_ctr`` (one AES
  pass on the host) and the HMAC hop schedule.  The device stage is then
  crypto-free.
* Per clip: 4-band sync correlation -> top-``peaks`` NMS peaks -> direct
  LS demod + refinement at ``len(SYNC_OFFSETS)`` alignments -> header
  decode -> counter resolution against the hop table -> PN gather ->
  payload LLR (hand-written CUDA kernel on the card) -> hard-decision
  polar + CRC -> one packed 60-byte verdict row per clip.
* The host finishes with the AEAD open + magic/ctr checks per clip, and
  resolves clips cut past the PN table with the extended-counter pass.

v2 / robust profile (``_batch_verify_stage_v2`` + ``RobustBatchVerifier``):
oversampled 504-tap sync (bf16 operands, float32 sums; one launch of
``csrc/sync_xcorr.cu`` on the card, its lag mask included), one LS product
against both lam profiles (no refinement), the standard polar info set,
and a ladder after the hard pass -- futility gate, staged SCL list decode
of each failing clip's top-4 soft rows, extended counters.  The soft rows
stay on the device; the host downloads only what it opens.
``verify_batch(fs_in=...)`` converts a capture's rate on the device first
(``ops/resample.py``), and ``verify_batch_recover`` adds the batched +-5%
playback-speed recovery: scaled-template scan, device resample per
recovered factor, re-verify, chained refinement.

Device rule: ``device=None`` means CUDA; without a card the verifiers
raise unless the caller passes ``device="cpu"``.  Precision rule: every
product is true float32 (the lam=1e-12 exact inversion does not survive
TF32), so constructing a verifier sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``.
"""
from __future__ import annotations

import typing
from math import gcd

import numpy as np
import torch

from echoseal_torch.convert import (
    TABLE_DTYPES,
    V2_TABLE_DTYPES,
    tables_from_numpy,
)
from echoseal_torch.core.bandplan import hop_schedule
from echoseal_torch.core.crypto import SecureChannel
from echoseal_torch.core.device import resolve_device
from echoseal_torch.core.params import FRAME_LEN, HDR_L, MAGIC, PRE_L, WIDE_DELTA
from echoseal_torch.core.profiles import ROBUST, WaveformProfile, profile_spec
from echoseal_torch.core.sequences import bits_to_bpsk, mls63
from echoseal_torch.models import robust
from echoseal_torch.ops import build, demod
from echoseal_torch.ops.llr import payload_decode
from echoseal_torch.ops.polar import PolarSpec, polar_spec
from echoseal_torch.ops.resample import DeviceResampler
from echoseal_torch.ops.scl import scl_decode_serving
from echoseal_torch.utils.logging import Timer, span_attrs

DEFAULT_MAX_CTR = 16_384     # ~7 min of stream @ 39.5 frames/s
DEFAULT_PEAKS = 2            # sync peaks examined per band per clip
N_OFFSETS = len(demod.SYNC_OFFSETS)

# SCL fallback list-size escalation: rungs below the configured list_size
# that still-failing clips climb through; the final rung is the configured
# list size, so the rescue set can only GROW vs a fixed-L fallback (rescue
# is a disjunction over rows and rungs, and every accept is AEAD-gated)
SCL_LADDER = (8, 32)


class ClipDetail(typing.NamedTuple):
    """Per-clip accept detail (which session/frame authenticated, where)."""

    session_nonce: bytes
    frame_ctr: int
    stage: str                # 'hard' | 'scl' | 'ext_ctr'
    # verify_batch_recover: the speed correction the clip was accepted at,
    # the retry lattice's rational (1.0: the first pass or the deferred
    # escalation, and every verify_batch accept)
    factor: float = 1.0


class _RetryGroup(typing.NamedTuple):
    """One lattice key's rows in a retry round of ``verify_batch_recover``."""

    rows: torch.Tensor        # (n, Tpad) resampled clips on the device
    members: list[int]        # their clip indices
    key: int                  # the RETRY_UP-lattice denominator
    lengths: list[int]        # their lengths after resampling
    on_host: bool             # resampled on the host (outside the family)


def resolve_sync_dtype(sync_dtype: str | None) -> torch.dtype:
    """The v2 sync precision: ``None``/``"bf16"`` -> bf16, ``"f32"`` -> f32.

    Anything else raises, so a typo such as ``"bfloat16"`` cannot silently
    select float32.
    """
    if sync_dtype is None or sync_dtype == "bf16":
        return torch.bfloat16
    if sync_dtype == "f32":
        return torch.float32
    raise ValueError(
        f"sync_dtype must be None, 'bf16' or 'f32', got {sync_dtype!r}")


def _mark(marks: list | None, name: str) -> None:
    """Record a CUDA event named ``name`` on the current stream."""
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))


@torch.no_grad()
def _batch_verify_stage(x: torch.Tensor, n_valid: torch.Tensor,
                        tables: dict[str, torch.Tensor],
                        peaks: int = DEFAULT_PEAKS,
                        marks: list | None = None) -> dict[str, torch.Tensor]:
    """(B, Tpad) float32 clips + (B,) true lengths -> stage outputs.

    ``tables`` holds the key's device tables (``convert.TABLE_DTYPES``).
    ``marks``, when a list, receives a ``(name, cuda.Event)`` as each
    stage's work is enqueued -- "sync_xcorr", "sync_nms", "demod_refine",
    "header_counter", "llr" (the fused ``payload_decode``: PN gather, LLR,
    hard decode, CRC), "hard_decode" (row gating and each clip's first
    CRC-passing row) -- for per-stage device times (CUDA only).
    """
    idx, val = _sync_stage(x, n_valid, tables["templates"], peaks, FRAME_LEN,
                           marks=marks)
    chips, pre_best = _demod_stage(x, idx, tables)
    _mark(marks, "demod_refine")
    out = _decode_stage(chips, idx, val, tables, marks)
    return dict(out, peak_idx=idx, peak_val=val, pre_score=pre_best,
                chips=chips)      # (B, 4, P, 1215) refined chip estimates


def _sync_stage(x, n_valid, templates, peaks, span, compute_dtype=None,
                marks=None):
    """4-band sync correlation over the valid lags -> NMS peaks (B, 4, P).

    A lag is valid while a whole frame of ``span`` samples fits before
    ``n_valid``; peaks are at least ``span // 2`` apart.  The bf16 sync is
    ``demod.sync_xcorr`` (the kernel on a card, its plain version on the
    CPU), which masks the lags itself; every float32 sync is
    ``normalized_xcorr``.
    """
    if compute_dtype == torch.bfloat16:
        corr = demod.sync_xcorr(x, templates, n_valid, span)
        _mark(marks, "sync_xcorr")
    else:
        corr = demod.normalized_xcorr(x, templates,
                                      compute_dtype=compute_dtype)
        _mark(marks, "sync_xcorr")
        lag = torch.arange(corr.shape[-1], device=x.device)
        corr.masked_fill_(lag > (n_valid[:, None, None] - span),
                          float("-inf"))
    out = demod.topk_nms(corr, peaks, span // 2)
    _mark(marks, "sync_nms")
    return out


def _demod_stage(x, idx, tables):
    """Windows at each peak's offsets -> LS demod + refine -> best offset.

    Returns (chips (B, 4, P, 1215), preamble score of the chosen offset).
    """
    B, T = x.shape
    peaks = idx.shape[-1]
    m_direct, pre_sy = tables["m_direct"], tables["pre_sy"]
    # one wide window per peak; the +-2 offsets are unfolded views of it
    o_min = min(demod.SYNC_OFFSETS)
    wide_w = demod.W_DIRECT + max(demod.SYNC_OFFSETS) - o_min
    s0 = torch.clamp(idx + o_min, 0, T - wide_w)
    wide = demod.slice_windows(x, s0, wide_w)               # (B,4,P,wide)
    win = wide.unfold(-1, demod.W_DIRECT, 1).reshape(
        B, 4, -1, demod.W_DIRECT)                           # (B,4,P*O,W)
    win = win * torch.rsqrt(torch.mean(win * win, -1, keepdim=True) + 1e-30)

    chips = demod.demod_chips(win, m_direct)
    chips = demod.refine_chips(win, chips, tables["t_fwd"], m_direct, pre_sy,
                               iters=4)

    pre = demod.preamble_score(chips, pre_sy).reshape(B, 4, peaks, N_OFFSETS)
    best_o = torch.argmax(torch.abs(pre), dim=-1)           # (B, 4, P)
    flat = torch.arange(peaks, device=x.device)[None, None, :] * N_OFFSETS \
        + best_o
    chips = torch.gather(
        chips.reshape(B, 4, peaks * N_OFFSETS, FRAME_LEN), 2,
        flat[..., None].expand(-1, -1, -1, FRAME_LEN))      # (B,4,P,1215)
    return chips, torch.gather(pre.reshape(B, 4, -1), -1, flat)


def _decode_stage(chips, idx, val, tables, marks=None, *,
                  spec: PolarSpec | None = None, span: int = FRAME_LEN,
                  soft_rows: int = 0):
    """Chips of every candidate -> header, counter, LLR, hard decode, row.

    Everything after the chip estimates: a pure function of ``chips`` and
    the peaks, so it can be run on chips from elsewhere.  ``chips`` is
    (B, 4, ..., P, 1215): the candidates of P peaks per band, with the v2
    lam profiles on the axes between; ``idx``/``val`` are the (B, 4, P)
    peaks, ``span`` the frame length in samples and ``spec`` the polar code
    (compat by default).

    ``soft_rows`` R > 0 (v2) also exports each clip's R best soft rows
    (highest mean |LLR| among plausible rows) with their counters for the
    SCL fallback, and appends the futility-gate evidence to the host row:
    any readable header (1 byte) and the best row's mean |LLR| (float32,
    little-endian) -> (B, 65).  A stable descending sort keeps
    ``lax.top_k``'s lower-index-first order on ties (-inf rows tie in
    bulk).  The extra work is marked "pack".
    """
    spec = spec or polar_spec()
    B, P = chips.shape[0], idx.shape[-1]
    dev = chips.device
    lattice = (B, 4) + (1,) * (chips.ndim - 4) + (P,)   # broadcasts on chips
    hdr_ok, lo16, hdr_score = demod.header_decode(chips, tables["hdr_pn_sy"])
    ctr_est = torch.round(idx.to(torch.float32) / span).to(torch.int32)
    pn_table, hop_table = tables["pn_table"], tables["hop_table"]
    band_ids = torch.arange(4, dtype=torch.int32, device=dev).reshape(
        1, 4, *lattice[2:-1], 1)
    ctr, any_match = _resolve_counters(
        hdr_ok, lo16, ctr_est.reshape(lattice), hop_table, band_ids,
        pn_table.shape[0])
    _mark(marks, "header_counter")

    # PN gather, LLR, hard decode and CRC in one kernel; the LLRs only
    # where the soft rows read them
    llr, info, crc_ok = payload_decode(chips, pn_table, ctr, spec,
                                       want_llr=bool(soft_rows))
    _mark(marks, "llr")
    row_ok = torch.isfinite(val).reshape(lattice) & any_match
    crc_ok = crc_ok & row_ok
    sel_ok, sel_ctr, blob, host_packed = _select_first(crc_ok, info, ctr)
    _mark(marks, "hard_decode")

    out = dict(
        ok=sel_ok, blob=blob, blob_ctr=sel_ctr,
        host_packed=host_packed,   # (B, 60) -- ONE host download
        crc_ok=crc_ok,             # (B, 4, ..., P)
        info_bits=info,            # (B, 4, ..., P, 440)
        ctr=ctr,                   # (B, 4, ..., P)
        hdr_ok=hdr_ok, hdr_score=hdr_score,
        hdr_lo16=lo16,             # (B, 4, ..., P) raw 16-bit header reads
    )
    if soft_rows:
        rows = torch.arange(B, device=dev)[:, None]
        quality = torch.where(row_ok, torch.mean(torch.abs(llr), dim=-1),
                              float("-inf")).reshape(B, -1)
        qv, qtop = torch.sort(quality, dim=-1, descending=True, stable=True)
        qv, qtop = qv[:, :soft_rows], qtop[:, :soft_rows]
        any_hdr = torch.any((hdr_ok & row_ok).reshape(B, -1), dim=-1)
        q_best = torch.where(torch.isfinite(qv[:, 0]), qv[:, 0], 0.0)
        out.update(
            scl_llr=llr.reshape(B, -1, llr.shape[-1])[rows, qtop],  # (B,R,1024)
            scl_ctr=ctr.reshape(B, -1)[rows, qtop],                 # (B, R)
            host_packed=torch.cat(
                [host_packed, any_hdr.to(torch.uint8)[:, None],
                 q_best.to(torch.float32).contiguous().view(torch.uint8)
                 .reshape(B, 4)], dim=1))
        _mark(marks, "pack")
    return out


@torch.no_grad()
def _ext_ctr_stage(chips_all, ii, bb, pp, pn_packed, spec: PolarSpec):
    """Extended-counter decode on the device: gather + despread + CRC.

    ``chips_all`` is the (B, 4, P, FRAME_LEN) chip tensor of the verify
    stage; ``pn_packed`` carries each row's payload PN as packed bits
    (MSB-first like np.packbits).  Returns ONE (rows, 1 + info_len/8)
    uint8 row: crc_ok | packed info bits.
    """
    chips = chips_all[ii, bb, pp].to(torch.float32)
    n = pn_packed.shape[0]
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=chips.device)
    bits = ((pn_packed[:, :, None] >> shifts) & 1).reshape(n, -1)
    _, info, crc_ok = payload_decode(
        chips, bits, torch.arange(n, device=chips.device), spec)
    return torch.cat([crc_ok.to(torch.uint8)[:, None], _pack_bits(info)], dim=1)


def _key_tables(sec: SecureChannel, hop, max_ctr: int):
    """Per-key tables: payload PN bits + hop band for every counter."""
    ctrs = np.arange(max_ctr, dtype=np.int64)
    pn = sec.pn_bits_batch(ctrs, FRAME_LEN)[:, PRE_L + HDR_L :]
    return pn.astype(np.int8), hop.indices(ctrs).astype(np.int32)


def host_tables(sec: SecureChannel, hop, fs: int,
                max_ctr: int) -> dict[str, np.ndarray]:
    """Every table the compat stage reads, as numpy arrays."""
    pn_table, hop_table = _key_tables(sec, hop, max_ctr)
    return dict(
        templates=demod.sync_templates(fs),
        m_direct=demod.all_direct_matrices(fs),      # exact-inversion profile
        t_fwd=demod.all_forward_matrices(fs),
        pre_sy=bits_to_bpsk(mls63()),
        hdr_pn_sy=bits_to_bpsk(sec.pn_bits(0, HDR_L)),
        pn_table=pn_table, hop_table=hop_table)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8m) {0,1} bits -> (..., m) uint8 bytes, MSB first (np.packbits)."""
    pow2 = 2 ** torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    grouped = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8)
    return torch.sum(grouped.to(torch.int32) * pow2, dim=-1).to(torch.uint8)


def _select_first(crc_ok, info, ctr):
    """Each clip's first CRC-passing candidate, packed into its host row.

    ``crc_ok`` (B, ...) and ``ctr`` (B, ...) span a clip's candidate
    lattice, ``info`` (B, ..., info_len) its decoded bits.  Returns
    (sel_ok (B,), sel_ctr (B,), blob (B, info_len/8), host_packed).
    """
    B = crc_ok.shape[0]
    flat_ok = crc_ok.reshape(B, -1)
    best = torch.argmax(flat_ok.to(torch.int32), dim=-1)    # first True
    rows = torch.arange(B, device=crc_ok.device)
    sel_ok = flat_ok[rows, best]
    sel_ctr = ctr.reshape(B, -1)[rows, best]
    blob = _pack_bits(info.reshape(B, -1, info.shape[-1])[rows, best])
    return sel_ok, sel_ctr, blob, _pack_host_row(sel_ok, sel_ctr, blob)


def _pack_host_row(sel_ok, sel_ctr, blob):
    """(B,) ok + (B,) int32 ctr + (B, 55) blob -> ONE (B, 60) uint8 row.

    Byte layout: ok(1) | ctr big-endian(4) | blob(55 at K = 448).
    """
    ctr_bytes = torch.stack(
        [(sel_ctr >> s) & 0xFF for s in (24, 16, 8, 0)], dim=-1).to(torch.uint8)
    return torch.cat([sel_ok.to(torch.uint8)[:, None], ctr_bytes, blob], dim=1)


def _resolve_counters(hdr_ok, lo16, ctr_est, hop_table, band_ids, max_ctr):
    """Header-gated absolute + time-estimate fallback counter resolution.

    All args broadcast against a (..., band, ...) candidate lattice;
    returns (ctr, any_match).  The 16-bit header identifies the counter
    absolutely below 2**16; counters past the table are left to the host's
    extended pass.
    """
    lo16c = torch.clamp(lo16, 0, max_ctr - 1)
    hdr_resolved = hdr_ok & (hop_table[lo16c.long()] == band_ids) & \
        (lo16 < max_ctr)
    deltas = torch.arange(-WIDE_DELTA, WIDE_DELTA + 1, dtype=torch.int32,
                          device=lo16.device)
    cand = torch.clamp(ctr_est[..., None] + deltas, 0, max_ctr - 1)
    match_nohdr = hop_table[cand.long()] == band_ids[..., None]
    dist = torch.abs(deltas) + torch.where(match_nohdr, 0, 1 << 20)
    j = torch.argmin(dist, dim=-1, keepdim=True)            # first on ties
    ctr_fb = torch.gather(cand, -1, j)[..., 0]
    ctr = torch.where(hdr_resolved, lo16c, ctr_fb)
    return ctr, hdr_resolved | torch.any(match_nohdr, dim=-1)


def host_tables_v2(sec: SecureChannel, hop, fs: int, max_ctr: int,
                   profile: WaveformProfile = ROBUST) -> dict[str, np.ndarray]:
    """Every table the v2 stage reads, as numpy arrays: the single-clip
    scan's design tables plus the per-key PN and hop tables."""
    pn_table, hop_table = _key_tables(sec, hop, max_ctr)
    return dict(robust.host_tables(sec, fs, profile),
                pn_table=pn_table, hop_table=hop_table)


@torch.no_grad()
def _batch_verify_stage_v2(x: torch.Tensor, n_valid: torch.Tensor,
                           tables: dict[str, torch.Tensor], *, peaks: int,
                           span: int, spec: PolarSpec,
                           sync_dtype: torch.dtype = torch.bfloat16,
                           marks: list | None = None
                           ) -> dict[str, torch.Tensor]:
    """One v2 (oversampled-profile) batch stage: (B, Tpad) clips -> outputs.

    ``tables`` holds the key's device tables (``convert.V2_TABLE_DTYPES``).
    Differences from the compat stage: ``sync_dtype`` sync over ``span``
    samples, one LS product against both lam profiles (no refinement), the
    standard polar info set (``spec``), and each clip's top-4 soft rows
    exported for the SCL fallback (``_decode_stage``).  ``marks`` (CUDA
    only) receives an event after each of "sync_xcorr", "sync_nms",
    "demod", "header_counter", "llr", "hard_decode" and "pack".
    """
    idx, val = _sync_stage(x, n_valid, tables["templates"], peaks, span,
                           compute_dtype=sync_dtype, marks=marks)
    win = demod.slice_windows(x, idx, span)                  # (B, 4, K, span)
    win = win * torch.rsqrt(torch.mean(win * win, -1, keepdim=True) + 1e-30)
    chips = demod.ls_demod(win, tables["m_stack"])           # (B,4,NP,K,1215)
    del win
    _mark(marks, "demod")
    out = _decode_stage(chips, idx, val, tables, marks, spec=spec, span=span,
                        soft_rows=min(4, 4 * chips.shape[2] * peaks))
    return dict(out, peak_idx=idx, peak_val=val,
                chips=chips)      # (B, 4, NP, K, 1215) -- extended pass


def _lengths_np(n_valid, clips) -> np.ndarray:
    """(B,) int32 numpy lengths; the full width when ``n_valid`` is None."""
    if n_valid is None:
        return np.full(clips.shape[0], clips.shape[-1], dtype=np.int32)
    return np.asarray(torch.as_tensor(n_valid).cpu()).astype(np.int32)


def _valid_peaks(out) -> np.ndarray:
    """(B, 4, P) peak positions on the host, -1 where the peak is invalid."""
    return torch.where(torch.isfinite(out["peak_val"]), out["peak_idx"],
                       -1).cpu().numpy()


class BatchVerifier:
    """High-throughput multi-clip verifier (one device stage per batch).

    ``device=None`` means CUDA and raises ``RuntimeError`` without a card;
    pass ``device="cpu"`` to run on the CPU.  Construction sets
    ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False (true float32 products).
    """

    _TABLE_DTYPES = TABLE_DTYPES

    def __init__(self, key32: bytes, *, fs: int = 48_000,
                 max_ctr: int = DEFAULT_MAX_CTR,
                 peaks: int = DEFAULT_PEAKS,
                 accept_legacy_plaintext: bool = False,
                 device: str | torch.device | None = None) -> None:
        device = resolve_device(device)
        sec = SecureChannel(key32)
        hop = hop_schedule(key32)
        self._setup(sec, hop, host_tables(sec, hop, fs, max_ctr), device,
                    fs=fs, peaks=peaks,
                    accept_legacy_plaintext=accept_legacy_plaintext)

    @classmethod
    def from_tables(cls, key32: bytes, tables: dict[str, np.ndarray], *,
                    device: str | torch.device | None = None, **options):
        """A verifier on given numpy tables (e.g. another verifier's).

        ``options`` are the constructor's keywords other than ``max_ctr``,
        which the tables fix.
        """
        self = cls.__new__(cls)
        self._setup(SecureChannel(key32), hop_schedule(key32), tables,
                    resolve_device(device), **options)
        return self

    def _setup(self, sec, hop, tables, device, *, fs: int = 48_000,
               peaks: int = DEFAULT_PEAKS,
               accept_legacy_plaintext: bool = False) -> None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.fs = fs
        self.sec = sec
        self._hop = hop
        self.peaks = int(peaks)
        self.accept_legacy_plaintext = bool(accept_legacy_plaintext)
        self.device = device
        self._spec = polar_spec()
        self.tables = tables_from_numpy(tables, device, self._TABLE_DTYPES)

    @property
    def max_ctr(self) -> int:
        return self.tables["pn_table"].shape[0]

    # ------------------------------------------------------------------ API
    def run_device(self, clips, n_valid=None, *,
                   marks: list | None = None) -> dict[str, torch.Tensor]:
        """Raw device stage outputs for a (B, T) float32 batch.

        ``clips`` and ``n_valid`` may be numpy arrays or tensors; they are
        moved to the verifier's device.  ``marks``: see
        ``_batch_verify_stage``.
        """
        return _batch_verify_stage(*self._inputs(clips, n_valid), self.tables,
                                   peaks=self.peaks, marks=marks)

    def _inputs(self, clips, n_valid):
        """(B, T) clips and (B,) lengths as float32 / int32 device tensors."""
        x = torch.as_tensor(clips, dtype=torch.float32, device=self.device)
        if n_valid is None:
            n_valid = np.full(x.shape[0], x.shape[1], dtype=np.int32)
        return x, torch.as_tensor(n_valid, dtype=torch.int32,
                                  device=self.device)

    def verify_batch(self, clips, n_valid=None, *,
                     expected_nonce: bytes | None = None,
                     max_stream_frames: int = 1 << 20,
                     details: dict[int, ClipDetail] | None = None
                     ) -> np.ndarray:
        """(B, T) float32 clips -> (B,) bool verdicts.

        Clips whose frame counters exceed the device PN table are resolved
        by the extended-counter pass: the 16-bit header pins
        ``ctr mod 2**16``, so candidates ``lo16 + m * 2**16`` up to
        ``max_stream_frames`` are despread with freshly generated PN and
        hard-decoded on the device -- only for clips the table pass missed.
        ``details`` (optional dict) collects a ``ClipDetail`` per accepted
        clip index.
        """
        def finish(out, packed, real):
            verdicts, _ = self.finish_host_detailed(
                out, expected_nonce=expected_nonce, details=details,
                packed=packed)
            pending = real & ~verdicts
            if pending.any():
                with Timer("verify.ext_ctr", rows=int(pending.sum())):
                    verdicts |= self._extended_counter_pass(
                        out, pending, expected_nonce, max_stream_frames,
                        details=details)
            return verdicts
        return self._verify_call(clips, n_valid, finish)

    def _verify_call(self, clips, n_valid, finish, ingest=None) -> np.ndarray:
        """The body of both tiers' ``verify_batch``: under the root span,
        ``ingest(clips, n_valid)`` when given (-> the clips and lengths to
        verify), the device stage, the one download of the host row, then
        ``finish(out, packed, real)`` -> (B,) verdicts.  ``real`` masks the
        padding rows (``n_valid == 0``): they can never verify, so they
        must not escalate."""
        with Timer("verify_batch", clips=len(clips)) as root:
            if ingest is not None:
                clips, n_valid = ingest(clips, n_valid)
            with Timer("verify.device") as sp:
                out = self.run_device(clips, n_valid,
                                      marks=sp.marks_for(self.device))
            packed = self._download_row(out)
            verdicts = finish(out, packed, _lengths_np(n_valid, clips) > 0)
            root.attrs["accepts"] = int(verdicts.sum())
        return verdicts

    def _download_row(self, out) -> np.ndarray:
        """The packed host row of the stage outputs ``out`` (one download,
        the span ``verify.download``)."""
        with Timer("verify.download") as sp:
            packed = out["host_packed"].cpu().numpy()
            sp.attrs["bytes"] = packed.nbytes
        return packed

    def _extended_counter_pass(self, out, mask: np.ndarray,
                               expected_nonce: bytes | None,
                               max_stream_frames: int,
                               details: dict[int, ClipDetail] | None = None
                               ) -> np.ndarray:
        """Header-gated ``lo16 + m*2**16`` fan-out beyond the PN table."""
        rescued = np.zeros(mask.shape[0], dtype=bool)
        n_mult = -(-max_stream_frames >> 16)
        if n_mult <= 0:
            return rescued
        B = mask.shape[0]
        # one download: readable headers as lo16, unreadable as -1
        with Timer("ext_ctr.download") as sp:
            lo16_or = torch.where(out["hdr_ok"], out["hdr_lo16"], -1).cpu(
            ).numpy().reshape(B, 4, -1)
            sp.attrs["bytes"] = lo16_or.nbytes
        hdr_ok = (lo16_or >= 0) & mask[:, None, None]
        ii0, bb0, pp0 = np.nonzero(hdr_ok)            # readable headers
        base = lo16_or[ii0, bb0, pp0].astype(np.int64)
        m = np.arange(n_mult, dtype=np.int64) << 16   # (n_mult,)
        cand = base[:, None] + m[None, :]             # (nh, n_mult)
        ok = (cand >= self.max_ctr) & (cand < max_stream_frames)
        if ok.any():
            with Timer("ext_ctr.hop", counters=int(ok.sum())):
                band_of = self._hop.indices(cand[ok].ravel())
            ok_flat = np.zeros(cand.shape, dtype=bool)
            ok_flat[ok] = band_of == np.repeat(bb0, n_mult).reshape(
                cand.shape)[ok]
            ok = ok_flat
        sel_r, sel_m = np.nonzero(ok)
        if sel_r.size == 0:
            return rescued
        ii, bb, pp = ii0[sel_r], bb0[sel_r], pp0[sel_r]
        ctrs = cand[sel_r, sel_m]

        # gather, despread and decode ON THE DEVICE; the PN of each
        # candidate counter goes up as packed bits, one verdict row down
        uniq, inv = np.unique(ctrs, return_inverse=True)
        with Timer("ext_ctr.pn", counters=int(uniq.size)):
            pn = self.sec.pn_bits_batch(uniq, FRAME_LEN)[:, PRE_L + HDR_L :]
            pnp = np.packbits(pn[inv].astype(np.uint8), axis=-1)
        dev = self.device
        chips_dev = out["chips"].reshape(B, 4, -1, FRAME_LEN)
        row = _ext_ctr_stage(
            chips_dev, *(torch.as_tensor(a, dtype=torch.int64, device=dev)
                         for a in (ii, bb, pp)),
            torch.as_tensor(pnp, device=dev), self._spec)
        with Timer("ext_ctr.download") as sp:
            host_row = row.cpu().numpy()
            sp.attrs["bytes"] = host_row.nbytes
        hits = np.flatnonzero(host_row[:, 0] > 0)
        with Timer("ext_ctr.open") as sp:
            nonces = self._accept_blobs(
                [host_row[r, 1:].tobytes() for r in hits], ctrs[hits],
                expected_nonce)
            for r, nonce in zip(hits, nonces):
                i = int(ii[r])
                if nonce is None or rescued[i]:
                    continue
                rescued[i] = True
                if details is not None:
                    details[i] = ClipDetail(nonce, int(ctrs[r]), "ext_ctr")
            sp.attrs["accepts"] = int(rescued.sum())
        return rescued

    def finish_host(self, out, *,
                    expected_nonce: bytes | None = None) -> np.ndarray:
        """AEAD verdicts from the device outputs (downloads ~60 B/clip)."""
        return self.finish_host_detailed(out, expected_nonce=expected_nonce)[0]

    def finish_host_detailed(self, out, *,
                             expected_nonce: bytes | None = None,
                             details: dict[int, ClipDetail] | None = None,
                             packed: np.ndarray | None = None):
        """(verdicts (B,) bool, nonces (B,) list[bytes|None]).

        A serving batch mixes clips from many sessions, so the anti-replay
        policy is the CALLER's: pass ``expected_nonce`` to enforce one
        session across the batch, or consume the returned per-clip nonces
        and latch per stream upstream.  ``packed``: the host row, when the
        caller has already downloaded it.
        """
        if packed is None:
            packed = self._download_row(out)
        packed = packed.astype(np.int64)
        ok = packed[:, 0] > 0
        ctrs = ((packed[:, 1] << 24) | (packed[:, 2] << 16)
                | (packed[:, 3] << 8) | packed[:, 4])
        # columns past the blob are the v2 evidence bytes (_parse_evidence)
        bw = self._spec.info_len // 8
        blobs = packed[:, 5:5 + bw].astype(np.uint8)
        verdicts = np.zeros(ok.shape[0], dtype=bool)
        nonces: list[bytes | None] = [None] * ok.shape[0]
        hits = np.flatnonzero(ok)
        with Timer("verify.open") as sp:
            accepted = self._accept_blobs([blobs[i].tobytes() for i in hits],
                                          ctrs[hits], expected_nonce)
            for i, nonce in zip(hits, accepted):
                if nonce is not None:
                    verdicts[i] = True
                    nonces[i] = nonce
                    if details is not None:
                        details[int(i)] = ClipDetail(nonce, int(ctrs[i]),
                                                     "hard")
            sp.attrs["accepts"] = int(verdicts.sum())
        retry = np.flatnonzero(ok & ~verdicts)
        if retry.size:
            with Timer("verify.other_candidates", rows=int(retry.size)):
                self._other_candidates(out, retry, expected_nonce, verdicts,
                                       nonces, details)
        return verdicts, nonces

    def _other_candidates(self, out, rows: np.ndarray,
                          expected_nonce: bytes | None, verdicts: np.ndarray,
                          nonces: list, details: dict | None) -> None:
        """Open the later CRC-passing candidates of clips whose first failed.

        CRC-8 passes a wrongly decoded candidate now and then; when that
        candidate is a clip's first CRC-passing one, the packed row carries
        it and would mask an authentic candidate behind it.  For those clips
        only (rare), the candidates' bits are downloaded and every other
        CRC-passing one goes through the same AEAD ladder, in lattice order.
        Updates ``verdicts``, ``nonces`` and ``details`` in place.
        """
        n = rows.size
        r = torch.as_tensor(rows, device=self.device)
        with Timer("other_candidates.download") as sp:
            crc = out["crc_ok"][r].reshape(n, -1).cpu().numpy()
            ctr = out["ctr"][r].reshape(n, -1).cpu().numpy()
            info = out["info_bits"][r].reshape(n, crc.shape[1], -1).to(
                torch.uint8).cpu().numpy()
            sp.attrs["bytes"] = crc.nbytes + ctr.nbytes + info.nbytes
        crc[np.arange(n), crc.argmax(1)] = False     # the packed row's, tried
        ii, cc = np.nonzero(crc)
        blobs = np.packbits(info[ii, cc], axis=-1)
        with Timer("other_candidates.open") as sp:
            accepted = self._accept_blobs([b.tobytes() for b in blobs],
                                          ctr[ii, cc], expected_nonce)
            before = int(verdicts.sum())
            for i, c, nonce in zip(ii, cc, accepted):
                k = int(rows[i])
                if nonce is None or verdicts[k]:
                    continue
                verdicts[k] = True
                nonces[k] = nonce
                if details is not None:
                    details[k] = ClipDetail(nonce, int(ctr[i, c]), "hard")
            sp.attrs["accepts"] = int(verdicts.sum()) - before

    def _accept_blobs(self, blobs: list[bytes], ctrs: np.ndarray,
                      expected_nonce: bytes | None) -> list[bytes | None]:
        """AEAD open + magic/ctr (+optional nonce) ladder per payload.

        Returns the session nonce of each accepted payload, None elsewhere.
        The reference's "legacy plaintext" acceptance (an unsealed payload
        passing on magic+ctr alone) bypasses AEAD, so it is OFF unless the
        caller opted in at construction.  While tracing, the open span
        around the call gets the ``blobs`` and the ``opens``: decrypt
        passes, one for a nonce-front payload, two for any other of 12
        bytes or more.
        """
        out: list[bytes | None] = []
        opened = self.sec.open_any_layout_many(blobs)
        attrs = span_attrs()
        if attrs is not None:
            attrs.update(blobs=len(blobs), opens=sum(
                1 if layout == "nonce-front" else 2 * (len(b) >= 12)
                for (_, layout), b in zip(opened, blobs)))
        for (plain, _), blob, ctr in zip(opened, blobs, ctrs):
            if plain is None and self.accept_legacy_plaintext and \
                    blob[:4] == MAGIC:
                plain = blob
            if plain is None or not plain.startswith(MAGIC) or \
                    int.from_bytes(plain[4:8], "big") != int(ctr):
                out.append(None)
                continue
            nonce = plain[8:16]
            out.append(nonce if expected_nonce in (None, nonce) else None)
        return out


class RobustBatchVerifier(BatchVerifier):
    """Batched v2 (robust-profile) verification.

    One device stage covers the whole batch through sync, LS demod (both
    regularisation profiles), header/counter resolution, LLR and the
    hard-decision polar pass; ``verify_batch`` then runs the ladder
    (``_finish_ladder``): futility gate, staged SCL list decode of the
    failing clips' soft rows on the device, extended counters.

    Shares the counter tables, host finisher and anti-replay hooks with
    the compat ``BatchVerifier``.  Tables are float32 (``table_dtype`` may
    only be ``None`` or ``"f32"``); the sync runs in bf16 unless
    ``sync_dtype="f32"``.  Device rule as for ``BatchVerifier``.
    """

    _TABLE_DTYPES = V2_TABLE_DTYPES

    # near-start headerless rescue (see _near_start_mask): a clip
    # escalates when >= MIN_ALIGNED sync peaks share one phase mod the
    # frame span within +-PHASE_TOL samples and the cluster starts inside
    # the wide counter window
    NEAR_START_MIN_ALIGNED = 6
    NEAR_START_PHASE_TOL = 32
    # clips per scale-scan dispatch of verify_batch_recover
    SCAN_CHUNK = 128

    def __init__(self, key32: bytes, *, fs: int = 48_000,
                 max_ctr: int = DEFAULT_MAX_CTR, peaks: int = 4,
                 list_size: int = 32,
                 profile: WaveformProfile | None = None,
                 table_dtype: str | None = None,
                 sync_dtype: str | None = None,
                 accept_legacy_plaintext: bool = False,
                 futility_qfloor: float | None = None,
                 device: str | torch.device | None = None) -> None:
        robust.resolve_table_dtype(table_dtype)
        device = resolve_device(device)
        profile = ROBUST if profile is None else profile
        sec = SecureChannel(key32)
        hop = hop_schedule(key32)
        self._setup(sec, hop, host_tables_v2(sec, hop, fs, max_ctr, profile),
                    device, fs=fs, peaks=peaks, list_size=list_size,
                    profile=profile, sync_dtype=sync_dtype,
                    accept_legacy_plaintext=accept_legacy_plaintext,
                    futility_qfloor=futility_qfloor)

    def _setup(self, sec, hop, tables, device, *, fs: int = 48_000,
               peaks: int = 4, list_size: int = 32,
               profile: WaveformProfile | None = None,
               sync_dtype: str | None = None,
               accept_legacy_plaintext: bool = False,
               futility_qfloor: float | None = None) -> None:
        super()._setup(sec, hop, tables, device, fs=fs, peaks=peaks,
                       accept_legacy_plaintext=accept_legacy_plaintext)
        self.profile = ROBUST if profile is None else profile
        self.span = self.profile.span
        self._spec = profile_spec(self.profile)
        self._list_size = int(list_size)
        self._sync_dtype = resolve_sync_dtype(sync_dtype)
        self._futility_qfloor = (float("inf") if futility_qfloor is None
                                 else float(futility_qfloor))
        # (rows, list size, n_rows, host seconds) of each SCL rung of the
        # last _scl_fallback call
        self.scl_rungs: list[tuple[str, int, int, float]] = []
        self._resamplers: dict[tuple, DeviceResampler] = {}
        self._scan_bank: torch.Tensor | None = None
        # what the last verify_batch_recover tried: "scan_rows" (clips
        # scanned), the counters "retry_rows" (rows re-verified over all
        # rounds), "dens" (the distinct retry denominators), "host_rows"
        # (rows resampled on the host); and per dispatched retry round
        # {"rows", "host_rows", "dens", "accepted", "clips" and "keys" (each
        # re-verified row's clip and lattice key, in the order of the
        # round's batch)}.  Its seconds are the recover.* spans'.
        self.recover_log: dict = {"rounds": []}

    # ------------------------------------------------------------------ API
    def run_device(self, clips, n_valid=None, *,
                   sync_dtype: str | None = None,
                   marks: list | None = None) -> dict[str, torch.Tensor]:
        """Raw v2 stage outputs; ``sync_dtype`` overrides for this call."""
        return _batch_verify_stage_v2(
            *self._inputs(clips, n_valid), self.tables, peaks=self.peaks,
            span=self.span, spec=self._spec,
            sync_dtype=(self._sync_dtype if sync_dtype is None
                        else resolve_sync_dtype(sync_dtype)),
            marks=marks)

    def verify_batch(self, clips, n_valid=None, *,
                     expected_nonce: bytes | None = None,
                     use_scl: bool = True,
                     max_stream_frames: int = 1 << 20,
                     fs_in: int | None = None,
                     details: dict[int, ClipDetail] | None = None
                     ) -> np.ndarray:
        """(B, T) float32 clips -> (B,) bool verdicts; ``fs_in`` for captures
        at another rate than ``self.fs``.

        Runs the device stage, then ``_finish_ladder``.  With ``fs_in``
        (e.g. 44100) the batch is rate-converted on the device first
        (``_ingest``), the batch-tier equivalent of a host ``resample_to``
        per clip; ``n_valid`` is then given in INPUT samples.  ``fs_in`` may
        be up to about 150 times ``self.fs`` (the resampler's
        ``RESAMPLE_MAX_K`` taps a phase); a faster capture is refused with
        ValueError.
        """
        ingest = None
        if fs_in is not None and int(fs_in) != self.fs:
            def ingest(clips, n_valid):
                with Timer("ingest.download"):
                    n_in = _lengths_np(n_valid, clips)
                with Timer("verify.ingest"):
                    return self._ingest(clips, n_in, int(fs_in))
        return self._verify_call(
            clips, n_valid,
            lambda out, packed, real: self._finish_ladder(
                out, expected_nonce, use_scl, max_stream_frames, real=real,
                details=details, packed=packed),
            ingest)

    def _resampler(self, up: int, down_min: int, down_max: int,
                   t_in: int) -> DeviceResampler:
        """The verifier's cached ``DeviceResampler`` for one family."""
        fam = (up, down_min, down_max, t_in)
        rs = self._resamplers.get(fam)
        if rs is None:
            rs = DeviceResampler(*fam, device=self.device)
            self._resamplers[fam] = rs
        return rs

    def _ingest(self, clips, n_valid: np.ndarray, fs_in: int):
        """Device rate conversion ``fs_in`` -> ``self.fs`` for a batch.

        Returns (the converted clips, a tensor as wide as the resampler's
        block lattice and exactly zero past each row's converted length,
        the converted lengths as int32 numpy).  Every later stage masks by
        the lengths, so the zero tail is inert.
        """
        g = gcd(self.fs, fs_in)
        up, down = self.fs // g, fs_in // g
        # decimating ratios reduce to tiny lattices (96 kHz -> up=1,
        # down=2) whose per-block overhang would dwarf the stride: scale
        # the lattice so each block yields >= 128 outputs
        m = -(-128 // up)
        up, down = up * m, down * m
        x = torch.as_tensor(clips, dtype=torch.float32, device=self.device)
        y, n_out = self._resampler(up, down, down, int(x.shape[-1]))(x, down)
        nv = np.minimum(np.asarray(n_valid).astype(np.int64) * up // down,
                        n_out).astype(np.int32)
        return y, nv

    def _parse_evidence(self, raw: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
        """(any_hdr (B,) bool, q_best (B,) f32) from the packed host row.

        The evidence bytes sit past the ok(1)+ctr(4)+blob row; a row
        without them (compat width) fails OPEN -- never drop a clip for
        lack of instrumentation.
        """
        row_w = 5 + self._spec.info_len // 8
        if raw.shape[1] < row_w + 5:
            n = raw.shape[0]
            return np.ones(n, bool), np.full(n, np.inf, np.float32)
        any_hdr = raw[:, row_w] > 0
        q = np.ascontiguousarray(
            raw[:, row_w + 1:row_w + 5]).view(np.float32).ravel()
        return any_hdr, q

    def _near_start_mask(self, out) -> np.ndarray:
        """Headerless clips whose counters the time estimate can resolve.

        True sync peaks sit on the stream's frame lattice, ``idx = ctr *
        span + phase``, so the largest cluster of peak phases mod span
        holds most of the candidate peaks, while noise argmaxes are
        uniform mod span (P(cluster >= 6 of 16) ~ 6e-7 at tol 32).  A clip
        escalates when such a cluster exists and it starts inside the
        wide counter window (``echoseal_tpu/models/pipeline.py``).
        """
        span, tol = self.span, self.NEAR_START_PHASE_TOL
        with Timer("gate.download") as sp:
            idx = torch.as_tensor(out["peak_idx"]).cpu().numpy()
            val = torch.as_tensor(out["peak_val"]).cpu().numpy()
            sp.attrs["bytes"] = idx.nbytes + val.nbytes
        idx = idx.reshape(idx.shape[0], -1).astype(np.int64)
        val = val.reshape(idx.shape)
        valid = np.isfinite(val)
        ph = idx % span                                     # (B, K)
        d = np.abs(ph[:, :, None] - ph[:, None, :])
        d = np.minimum(d, span - d)                         # circular
        pair_ok = (d <= tol) & valid[:, :, None] & valid[:, None, :]
        cluster = pair_ok.sum(axis=2)                       # (B, K)
        anchor = np.argmax(cluster, axis=1)                 # cluster rep
        in_cluster = np.take_along_axis(
            pair_ok, anchor[:, None, None], axis=1)[:, 0]   # (B, K)
        ctr_est = np.rint(idx / span)
        ctr_min = np.where(in_cluster, ctr_est, np.inf).min(axis=1)
        return ((cluster.max(axis=1) >= self.NEAR_START_MIN_ALIGNED)
                & (ctr_min < WIDE_DELTA))

    def _finish_ladder(self, out, expected_nonce, use_scl: bool,
                       max_stream_frames: int,
                       real: np.ndarray | None = None,
                       details: dict[int, ClipDetail] | None = None,
                       packed: np.ndarray | None = None) -> np.ndarray:
        """Hard verdicts -> futility gate -> staged SCL -> extended ctrs.

        ``real`` masks padding rows (n_valid == 0), which never escalate.
        The futility gate: a clip with no readable header in any candidate
        row cannot be rescued (its counter, hence its PN, is unknown), so
        it skips the ladder, unless ``futility_qfloor`` lets its best soft
        row's mean |LLR| through or ``_near_start_mask`` finds it cut near
        the stream start, where the time estimate resolves the counter.
        ``packed``: the host row, when the caller has already downloaded
        it.  ``scl_rungs`` then describes this call's ladder.
        """
        self.scl_rungs = []
        if packed is None:
            packed = self._download_row(out)
        verdicts, _ = self.finish_host_detailed(
            out, expected_nonce=expected_nonce, details=details, packed=packed)
        if real is None:
            real = np.ones(verdicts.shape, bool)
        with Timer("verify.gate") as sp:
            any_hdr, q_best = self._parse_evidence(packed)
            evidence = any_hdr | (q_best >= self._futility_qfloor)
            pending_nohdr = real & ~verdicts & ~evidence
            if use_scl and pending_nohdr.any():
                evidence |= pending_nohdr & self._near_start_mask(out)
            pending = real & ~verdicts & evidence
            sp.attrs["rows"] = int(pending.sum())
        if use_scl and pending.any():
            with Timer("verify.ladder", rows=int(pending.sum())) as sp:
                rescued = self._scl_fallback(out, pending, expected_nonce,
                                             details=details)
                sp.attrs["rescued"] = int(rescued.sum())
            verdicts |= rescued
            pending = real & ~verdicts & evidence
        # the extended-counter pass can only act on readable headers
        pending &= any_hdr
        if pending.any():
            with Timer("verify.ext_ctr", rows=int(pending.sum())):
                verdicts |= self._extended_counter_pass(
                    out, pending, expected_nonce, max_stream_frames,
                    details=details)
        return verdicts

    # ------------------------------------------------- time-scale recovery
    def verify_batch_recover(self, clips, n_valid=None, *,
                             expected_nonce: bytes | None = None,
                             fs_in: int | None = None,
                             details: dict[int, ClipDetail] | None = None
                             ) -> np.ndarray:
        """``verify_batch`` plus batched +-5% playback-speed recovery.

        Clips the plain pass misses get a sync-only scaled-template scan
        (failing rows gathered on the device from the clip batch, scanned
        in chunks of <= 128 clips), are resampled per recovered factor on
        the device (one pass per distinct factor on the ``RETRY_UP``
        lattice), re-verified in one stage, and still-failing clips get
        chained inter-peak-spacing refinement, fallback factors and
        lattice neighbours for up to four more rounds (``_retry_scaled``).

        ``fs_in`` composes the device ingest conversion with recovery: the
        scan and retries run on the ingested batch at ``self.fs``; the
        host resample path (factor groups outside the device family,
        ``RETRY_REACH``) corrects straight from the original-rate host
        clips in ONE polyphase pass (up = fs, down = round(fs_in *
        factor)).

        ``clips`` may be a ``torch.Tensor`` already on the verifier's
        device: then nothing is uploaded, and host bytes are materialised
        (one download) only if some retry factor falls outside the device
        family, which neither the scan grid nor the refinement produces.

        ``details`` (optional dict) collects a ``ClipDetail`` per accepted
        clip index, as ``verify_batch``'s does, with the ``factor`` the
        clip was accepted at.  Spans: ``verify_batch_recover`` (``clips``,
        ``accepts``, and the counters ``retry_rows``, ``dens``,
        ``host_rows``) > ``recover.first_pass``, ``recover.scan``,
        ``recover.round`` (> ``recover.resample``), ``recover.deferred``.
        """
        log = self.recover_log = {"scan_rows": 0, "retry_rows": 0,
                                  "dens": [], "host_rows": 0, "rounds": []}
        with Timer("verify_batch_recover", clips=len(clips)) as root:
            verdicts = self._recover(clips, n_valid, expected_nonce, fs_in,
                                     details)
            log["dens"] = sorted({d for r in log["rounds"]
                                  for d in r["dens"]})
            root.attrs.update(accepts=int(verdicts.sum()),
                              retry_rows=log["retry_rows"],
                              dens=len(log["dens"]),
                              host_rows=log["host_rows"])
        return verdicts

    def _recover(self, clips, n_valid, expected_nonce: bytes | None,
                 fs_in: int | None, details: dict | None) -> np.ndarray:
        """The body of ``verify_batch_recover``."""
        dev_in = isinstance(clips, torch.Tensor)
        if not dev_in:
            clips = np.asarray(clips, dtype=np.float32)
        n_valid = _lengths_np(n_valid, clips)
        clips_host = None if dev_in else clips
        nv_host = n_valid
        fs_host = self.fs if fs_in is None else int(fs_in)
        if fs_in is not None and int(fs_in) != self.fs:
            clips_dev, n_valid = self._ingest(clips, n_valid, int(fs_in))
        else:
            clips_dev = torch.as_tensor(clips, dtype=torch.float32,
                                        device=self.device)
        real = n_valid > 0
        with Timer("recover.first_pass") as sp:
            marks = sp.marks_for(self.device)
            out = self.run_device(clips_dev, n_valid)
            _mark(marks, "device")
            # hard verdicts ONLY here: on a time-scaled batch every clip
            # fails the hard pass AND cannot SCL-decode (the chip timing is
            # off), so the full ladder would burn list decodes before the
            # scan even ran.  Escalation moves BEHIND the scan: recovered
            # clips get the full ladder inside the retry re-verify; clips
            # the scan could not place (or whose retry failed) get the
            # deferred escalation against these SAME device outputs below
            # -- verdict-identical, rescue is a disjunction over attempts.
            verdicts = self._finish_ladder(out, expected_nonce, False, 0,
                                           real=real, details=details)
        fail = np.flatnonzero(real & ~verdicts)
        if fail.size == 0:
            return verdicts

        bank = self._device_scan_bank()
        chunks = range(0, fail.size, self.SCAN_CHUNK)
        with Timer("recover.scan", rows=int(fail.size),
                   chunks=len(chunks)) as sp:
            marks = sp.marks_for(self.device)
            nv_dev = torch.as_tensor(n_valid, device=self.device)
            score_parts = []
            for c0 in chunks:
                idx = torch.as_tensor(fail[c0:c0 + self.SCAN_CHUNK],
                                      device=self.device)
                score_parts.append(robust._scale_scan_batch(
                    clips_dev[idx], nv_dev[idx], bank))
            _mark(marks, "scan")
            with Timer("scan.download") as dl:
                scores = np.concatenate(
                    [np.asarray(torch.as_tensor(p).cpu())
                     for p in score_parts])
                dl.attrs["bytes"] = scores.nbytes
        self.recover_log["scan_rows"] = int(fail.size)
        factors, fallback = self._scan_factors(scores, fail, out)
        # depth 4: a clip whose correct-basin factor is only reached by
        # the fallback queue still needs a round for its sub-lattice
        # residual; rounds with no candidates cost nothing
        verdicts = self._retry_scaled(clips_host, nv_host, factors, verdicts,
                                      expected_nonce, refine=4,
                                      clips_dev=clips_dev, nv_dev=n_valid,
                                      fs_host=fs_host, fallback=fallback,
                                      details=details)
        left = real & ~verdicts
        if left.any():          # the deferred escalation
            with Timer("recover.deferred", rows=int(left.sum())):
                verdicts |= self._finish_ladder(out, expected_nonce, True,
                                                1 << 20, real=left,
                                                details=details)
        return verdicts

    def _scan_factors(self, scores: np.ndarray, fail: np.ndarray, out
                      ) -> tuple[dict[int, float], dict[int, list[float]]]:
        """The first retry round's factors and each clip's fallback queue.

        ``scores`` are the scan's (len(fail), 31 * 4) scores of the failing
        clips ``fail``, ``out`` the first pass's stage outputs.  Returns
        ({clip: factor}, {clip: [fallback factors, in order]}).
        """
        grid = np.asarray(robust.SCALE_SCAN_GRID)
        per = scores.reshape(fail.size, grid.size, 4).max(axis=2)
        f = grid[np.argmax(per, axis=1)]
        # NO evidence gate here: a retry row in the batched re-verify is
        # nearly free, while a gated-out scaled clip is lost for good.  A
        # junk factor cannot false-accept (AEAD) and the deferred
        # escalation still covers the un-scaled failure modes.
        # Clips whose scan argmax is the identity get the inter-peak-
        # spacing estimate from the ORIGINAL device outputs instead:
        # sub-grid residuals show up there, not in the 0.33%-step scan.
        peaks0 = _valid_peaks(out)
        factors: dict[int, float] = {}
        for pos, i in enumerate(fail):
            cand = float(f[pos])
            if abs(cand - 1.0) <= 1e-4:
                fine = robust.estimate_timescale_from_peaks(peaks0[i],
                                                            self.span)
                if fine is None or abs(fine - 1.0) <= robust.FINE_CHAIN_MIN:
                    continue
                cand = float(fine)
            factors[int(i)] = cand
        # Fallback candidate queue, consumed by the refinement rounds when
        # a failed retry yields no peak-spacing estimate: the scan's known
        # aliasing mode is the RECIPROCAL basin (a template stretched by r
        # also part-correlates against a clip stretched by r); the retry
        # at the wrong factor shows no peaks and the refiner abstains.
        # Queue per clip: the reciprocal of the primary, then the
        # second-best scan factor OUTSIDE the primary's basin.
        order = np.argsort(per, axis=1)[:, ::-1]
        fallback: dict[int, list[float]] = {}
        for pos, i in enumerate(fail):
            f1 = factors.get(int(i))
            if f1 is None:      # scan says unscaled: deferred escalation
                continue        # covers it; no retry rows to feed
            alts: list[float] = []
            r = 1.0 / f1
            if 0.95 <= r <= 1.05 and abs(r - f1) > 1e-4:
                alts.append(float(r))
            for j in order[pos][1:]:
                f2 = float(grid[j])
                if (abs(f2 - 1.0) > 1e-4 and abs(f2 - f1) > 0.0034
                        and all(abs(f2 - a) > 1e-3 for a in alts)):
                    alts.append(f2)
                    break
            if alts:
                fallback[int(i)] = alts
        return factors, fallback

    # retry-lattice denominator: factors quantize to RETRY_UP-lattice
    # rationals (granularity 1/RETRY_UP = 8.3e-5, ~2.4x inside the demod's
    # ~2e-4 coherence budget).  12000, not fs=48000: the per-factor tap
    # table scales with ``up`` (1.2 MB vs 4.6 MB), the 31 scan-grid
    # factors are exact on both lattices with IDENTICAL reduced ratios
    # (gcd collapses them, so resample_poly outputs are equal), and the
    # coarser lattice clusters per-clip refinement estimates onto shared
    # denominators (one resample pass serves the cluster).
    RETRY_UP = 12_000

    def _device_scan_bank(self) -> torch.Tensor:
        """The scaled sync-template bank of the time-scale scan on this
        verifier's device, designed on the host at first use (seconds)."""
        if self._scan_bank is None:
            self._scan_bank = robust.device_scan_bank(
                robust.scaled_template_bank(self.fs, self.profile.oversample),
                self.device)
        return self._scan_bank

    # every correction factor a device batch's retry rounds can reach: the
    # scan's +-5 % grid, then up to four refinement rounds, each a chained
    # estimate of at most 2 % or a lattice neighbour.  A key outside the
    # device family takes the host path, which downloads the whole clip
    # batch to resample its rows (755 MB at 1024 x 184 384: a fifth of
    # the card's busy time in an H100 run of such calls), so the family
    # spans the whole reach; the widening costs the resample ~10 %
    RETRY_REACH = (0.95 * 0.98 ** 4, 1.05 * 1.02 ** 4)

    def _device_resampler(self, t_in: int) -> DeviceResampler:
        """The device resampler family of the retry rounds (every factor
        of ``RETRY_REACH``, four lattice steps beyond) for ``t_in``-wide
        clips."""
        lo, hi = self.RETRY_REACH
        return self._resampler(self.RETRY_UP, int(self.RETRY_UP * lo) - 4,
                               int(self.RETRY_UP * hi) + 4, t_in)

    def _retry_scaled(self, clips, n_valid, factors: dict[int, float],
                      verdicts: np.ndarray, expected_nonce: bytes | None,
                      refine: int, clips_dev, nv_dev,
                      fs_host: int | None = None,
                      fallback: dict[int, list[float]] | None = None,
                      tried: dict[int, set] | None = None,
                      details: dict[int, ClipDetail] | None = None,
                      depth: int = 0) -> np.ndarray:
        """One retry round, then the next (``refine`` more at most).

        The ``factors`` clips are grouped by their key on the ``RETRY_UP``
        lattice, resampled per group, re-verified in one stage with the
        full ladder, and the still-failing ones get their next factor
        (``_next_factors``).  ``clips_dev`` is the clip batch on the device
        at ``self.fs`` and ``nv_dev`` its lengths.  A group whose key lies
        in the device resampler's family (``RETRY_REACH``) resamples there;
        any other group resamples on the host from ``clips``, the capture
        at ``fs_host`` with lengths ``n_valid`` (when None, from one host
        copy of ``clips_dev``), in one polyphase pass that composes the
        rate conversion with the same rational correction.
        ``tried`` collects, per clip, the lattice keys attempted;
        ``details`` the accepts, each with its lattice factor; ``depth``
        counts the rounds before this one (the span ``recover.round``).
        """
        from scipy.signal import resample_poly

        if not factors:
            return verdicts
        q = self.RETRY_UP
        with Timer("recover.round", depth=depth) as span:
            # the retry batch lives on the device timeline at self.fs; the
            # host clips may be at another capture rate (fs_host, from the
            # verify_batch_recover(fs_in=...) ingest composition)
            fs_host = self.fs if fs_host is None else int(fs_host)
            nv_dev = np.asarray(nv_dev, np.int32)
            Tpad = clips_dev.shape[1]
            rs = self._device_resampler(Tpad)
            # group by lattice key, not raw float factor: per-clip
            # refinement estimates that quantize to the same key must share
            # one resample pass (and one cached tap table)
            tried = {} if tried is None else tried
            groups: dict[int, list[int]] = {}
            rep_f: dict[int, float] = {}
            for i, f in factors.items():
                key = int(round(q * f))
                tried.setdefault(i, set()).add(key)
                groups.setdefault(key, []).append(i)
                rep_f.setdefault(key, float(f))
            # identity: re-verifying the same clip is a no-op and the
            # resampler rejects factor 1.0
            groups.pop(q, None)

            recs: list[_RetryGroup] = []
            for den, members in groups.items():
                if rs.down_min <= den <= rs.down_max:
                    with Timer("recover.resample", rows=len(members),
                               den=den) as rsp:
                        marks = rsp.marks_for(self.device)
                        misses = rs.misses
                        launches = build.LAUNCHES["resample"]
                        y, n_out = rs(clips_dev, den, rows=members,
                                      width=Tpad)
                        _mark(marks, "resample")
                        rsp.attrs.update(
                            miss=rs.misses - misses,
                            launches=build.LAUNCHES["resample"] - launches)
                    L = min(n_out, Tpad)
                    recs.append(_RetryGroup(
                        y, members, den,
                        [min(int(int(nv_dev[i]) * q / den), L)
                         for i in members], False))
                    continue
                if clips is None:
                    # device-resident caller: materialise host bytes once.
                    # The rows live on the INGESTED device timeline at
                    # self.fs, not at the fs_host capture rate -- rebase
                    # the host-path rate and lengths, or a 44.1 kHz fs_in
                    # caller gets a spurious ~8.8% extra speed shift here.
                    clips, n_valid, fs_host = (clips_dev.cpu().numpy(),
                                               nv_dev, self.fs)
                den_h = int(round(fs_host * rep_f[den]))
                g = gcd(self.fs, den_h)
                y = resample_poly(clips[members], self.fs // g, den_h // g,
                                  axis=-1)
                L = min(y.shape[1], Tpad)
                rows = np.zeros((len(members), Tpad), np.float32)
                rows[:, :L] = y[:, :L]
                recs.append(_RetryGroup(
                    torch.as_tensor(rows, device=self.device), members, den,
                    [min(int(int(n_valid[i]) * self.fs / den_h), L)
                     for i in members], True))
            # the round's batch: device groups first, then host groups,
            # each in the order the clips' factors came
            recs.sort(key=lambda r: r.on_host)
            sel = [i for r in recs for i in r.members]
            keys = [r.key for r in recs for _ in r.members]
            host_rows = sum(len(r.members) for r in recs if r.on_host)
            dens = sorted(r.key for r in recs)
            span.attrs.update(rows=len(sel), host_rows=host_rows,
                              dens=len(dens), accepted=0)
            if not sel:             # every group was the lattice identity
                return verdicts
            batch = (recs[0].rows if len(recs) == 1
                     else torch.cat([r.rows for r in recs]))
            nv2 = np.asarray([n for r in recs for n in r.lengths], np.int32)
            out = self.run_device(batch, nv2)
            # drop THIS round's staging buffers before the ladder and the
            # next round: each round would otherwise pin its own batch of
            # resampled rows down the recursion
            del batch, recs
            got = {} if details is not None else None
            vr = self._finish_ladder(out, expected_nonce, True, 1 << 20,
                                     real=nv2 > 0, details=got)
            for r, d in (got or {}).items():
                if not verdicts[sel[r]]:
                    details[sel[r]] = d._replace(factor=keys[r] / q)
            for r, i in enumerate(sel):
                verdicts[i] |= vr[r]
            span.attrs["accepted"] = int(vr.sum())
            log = self.recover_log
            log["retry_rows"] = log.get("retry_rows", 0) + len(sel)
            log["host_rows"] = log.get("host_rows", 0) + host_rows
            log["rounds"].append(
                {"rows": len(sel), "host_rows": host_rows, "dens": dens,
                 "accepted": int(vr.sum()), "clips": sel, "keys": keys})
            if refine <= 0:
                return verdicts
            peaks = _valid_peaks(out)
            # this round's stage outputs (chips + soft rows) are fully
            # consumed now -- free them BEFORE the next round so only one
            # round's outputs are ever live
            del out
            nxt = self._next_factors(sel, peaks, factors, verdicts, tried,
                                     fallback)
        # the next round runs after this round's span has closed, so each
        # ``recover.round`` holds its own round's work alone
        return self._retry_scaled(clips, n_valid, nxt, verdicts,
                                  expected_nonce, refine=refine - 1,
                                  clips_dev=clips_dev, nv_dev=nv_dev,
                                  fs_host=fs_host, fallback=fallback,
                                  tried=tried, details=details,
                                  depth=depth + 1)

    def _next_factors(self, sel: list[int], peaks: np.ndarray,
                      factors: dict[int, float], verdicts: np.ndarray,
                      tried: dict[int, set],
                      fallback: dict[int, list[float]] | None
                      ) -> dict[int, float]:
        """The next round's factor of each still-failing clip of a round.

        ``sel`` are the round's clips in the order of its batch, ``peaks``
        its (rows, 4, P) valid peaks, ``factors`` the factors it tried.
        Chained inter-peak-spacing refinement first; a clip whose failed
        retry shows NO usable spacing estimate (wrong-basin factor -> no
        peaks) pulls its next ``fallback`` candidate instead (the queue is
        consumed); then the lattice neighbours of the factor just tried.
        ``tried`` dedupes on the retry lattice, so a candidate that merely
        re-quantizes to an already-attempted rational is skipped.
        """
        q = self.RETRY_UP
        nxt: dict[int, float] = {}
        for r, i in enumerate(sel):
            if verdicts[i]:
                continue
            cand = None
            fine = robust.estimate_timescale_from_peaks(peaks[r], self.span)
            # lower bound FINE_CHAIN_MIN, not 1e-4: that would mask the
            # retry lattice's own quantization residual (up to ~8.3e-5 off
            # the scan pick).  Upper bound 2%: a chained estimate measures
            # the RESIDUAL after a correction was applied, so a large value
            # is estimator junk (few/noisy spacings), not signal -- a
            # wrong-basin retry's true residual is ~6%+, outside the
            # estimator's own 6% gate anyway, and basin hops are the
            # fallback queue's job.
            if (fine is not None and
                    robust.FINE_CHAIN_MIN < abs(fine - 1.0) <= 0.02):
                c = factors[i] * fine
                # k == q is the identity on the retry lattice: a chained
                # estimate that cancels (f1 * fine -> ~1.0) must fall
                # through to the fallback queue, not reach the resampler
                # (which raises on factor 1.0)
                k = int(round(q * c))
                if k != q and k not in tried[i]:
                    cand = c
            while cand is None and fallback and fallback.get(i):
                c = fallback[i].pop(0)
                k = int(round(q * c))
                if k != q and k not in tried.get(i, set()):
                    cand = c
            if cand is None:
                # last resort: the retry lattice's own quantization
                # neighbours of the factor just tried.  A clip can sit a
                # half-lattice-step (~4e-5) off its best rational and fail
                # there while the adjacent step decodes, with no
                # peak-spacing estimate to chain from.
                k0 = int(round(q * factors[i]))
                for k in (k0 + 1, k0 - 1):
                    if k != q and k not in tried.get(i, set()):
                        cand = k / q
                        break
            if cand is not None:
                nxt[i] = cand
        return nxt

    # ----------------------------------------------------------- SCL stage
    def _scl_fallback(self, out, mask: np.ndarray,
                      expected_nonce: bytes | None,
                      details: dict[int, ClipDetail] | None = None
                      ) -> np.ndarray:
        """List-decode the exported top-R soft rows of each masked clip.

        Doubly staged, as in the JAX package: rows (each clip's best soft
        row first, rows 1..R-1 only for the remainder) x list size
        (``SCL_LADDER`` rungs below the configured list size, then the
        list size), each rung only on still-failing clips.  The rows stay
        on the device; per rung the host downloads the CRC flags and the
        packed bytes of the CRC-passing paths, and opens them in (row,
        list) order.  Each rung decodes through ``scl_decode_serving``:
        exact unless ``ECHOSEAL_SCL_SERVING`` or ``ECHOSEAL_SCL_IMPL``
        selects the fast-SSCL walk (``ops/scl.py``).
        """
        rescued = np.zeros(mask.shape[0], dtype=bool)
        clips_f = np.flatnonzero(mask)
        if clips_f.size == 0:
            return rescued
        sel = torch.as_tensor(clips_f, device=self.device)
        llr = out["scl_llr"][sel]                           # (F, R, 1024)
        with Timer("ladder.download") as sp:
            ctrs = out["scl_ctr"][sel].cpu().numpy()        # (F, R)
            sp.attrs["bytes"] = ctrs.nbytes
        R = llr.shape[1]
        ladder = ([L for L in SCL_LADDER if L < self._list_size]
                  + [self._list_size])
        pending = np.arange(clips_f.size)
        for lo, hi in ((0, 1), (1, R)):
            for lsize in ladder:
                if pending.size == 0 or lo >= hi:
                    continue
                sub_ctr = ctrs[pending, lo:hi].reshape(-1)
                with Timer("ladder.rung", rows=len(sub_ctr),
                           list_size=lsize) as rung:
                    rung.attrs["rescued"] = self._scl_rung(
                        llr[:, lo:hi], pending, lsize, sub_ctr, clips_f,
                        rescued, expected_nonce, details)
                self.scl_rungs.append((f"{lo}:{hi}", lsize, len(sub_ctr),
                                       rung.elapsed))
                pending = pending[~rescued[clips_f[pending]]]
        return rescued

    def _scl_rung(self, llr, pending, lsize, sub_ctr, clips_f, rescued,
                  expected_nonce, details) -> int:
        """One rung: list-decode the soft rows ``llr`` (F, w, 1024) of the
        ``pending`` clips at list size ``lsize``, open the CRC-passing paths
        in (row, list) order, and mark the rescued clips in ``rescued`` and
        ``details``.  Returns how many it rescued."""
        dev = self.device
        w = llr.shape[1]
        with Timer("ladder.decode") as sp:
            marks = sp.marks_for(dev)
            sub = llr[torch.as_tensor(pending, device=dev)]
            res = scl_decode_serving(sub.reshape(-1, sub.shape[-1]),
                                     self._spec, lsize)
            _mark(marks, "decode")
        with Timer("ladder.download") as sp:
            rr, ll = np.nonzero(res["crc_ok"].cpu().numpy())
            blobs = _pack_bits(res["info_bits"][
                torch.as_tensor(rr, device=dev),
                torch.as_tensor(ll, device=dev)]).cpu().numpy()
            sp.attrs["bytes"] = blobs.nbytes
        with Timer("ladder.open") as sp:
            accepted = self._accept_blobs([b.tobytes() for b in blobs],
                                          sub_ctr[rr], expected_nonce)
            new = 0
            for r, nonce in zip(rr, accepted):
                i = clips_f[pending[r // w]]
                if nonce is None or rescued[i]:
                    continue
                rescued[i] = True
                new += 1
                if details is not None:
                    details[int(i)] = ClipDetail(nonce, int(sub_ctr[r]),
                                                 "scl")
            sp.attrs["accepts"] = new
        return new
