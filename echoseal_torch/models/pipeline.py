"""Batched multi-clip verification -- the compat serving pipeline in torch.

The counterpart of ``echoseal_tpu/models/pipeline.py``'s compat tier
(``_batch_verify_stage`` + ``BatchVerifier``):

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

Device rule: ``device=None`` means CUDA; without a card the verifier
raises unless the caller passes ``device="cpu"``.  Precision rule: every
product is true float32 (the lam=1e-12 exact inversion does not survive
TF32), so constructing a verifier sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from echoseal_torch.convert import tables_from_numpy
from echoseal_torch.core.bandplan import hop_schedule
from echoseal_torch.core.crypto import SecureChannel
from echoseal_torch.core.params import FRAME_LEN, HDR_L, MAGIC, PRE_L, WIDE_DELTA
from echoseal_torch.core.sequences import bits_to_bpsk, mls63
from echoseal_torch.ops import demod
from echoseal_torch.ops.llr import payload_llr
from echoseal_torch.ops.polar import PolarSpec, hard_decode_batch, polar_spec

DEFAULT_MAX_CTR = 16_384     # ~7 min of stream @ 39.5 frames/s
DEFAULT_PEAKS = 2            # sync peaks examined per band per clip
N_OFFSETS = len(demod.SYNC_OFFSETS)


class ClipDetail(typing.NamedTuple):
    """Per-clip accept detail (which session/frame authenticated, where)."""

    session_nonce: bytes
    frame_ctr: int
    stage: str                # 'hard' | 'ext_ctr'


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> CUDA, which must exist; anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the verifier on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


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
    "header_counter", "llr", "hard_decode" -- for per-stage device times
    (CUDA only).
    """
    idx, val = _sync_stage(x, n_valid, tables["templates"], peaks, marks)
    chips, pre_best = _demod_stage(x, idx, tables)
    _mark(marks, "demod_refine")
    out = _decode_stage(chips, idx, val, tables, marks)
    return dict(out, peak_idx=idx, peak_val=val, pre_score=pre_best,
                chips=chips)      # (B, 4, P, 1215) refined chip estimates


def _sync_stage(x, n_valid, templates, peaks, marks=None):
    """4-band sync correlation over the valid lags -> NMS peaks (B, 4, P)."""
    corr = demod.normalized_xcorr(x, templates)            # (B, 4, T-62)
    _mark(marks, "sync_xcorr")
    lag = torch.arange(corr.shape[-1], device=x.device)
    corr.masked_fill_(lag > (n_valid[:, None, None] - FRAME_LEN), float("-inf"))
    out = demod.topk_nms(corr, peaks, FRAME_LEN // 2)
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


def _decode_stage(chips, idx, val, tables, marks=None):
    """Chips of every candidate -> header, counter, LLR, hard decode, row.

    Everything after the chip estimates: a pure function of ``chips`` and
    the peaks, so it can be run on chips from elsewhere.
    """
    B = chips.shape[0]
    dev = chips.device
    hdr_ok, lo16, hdr_score = demod.header_decode(chips, tables["hdr_pn_sy"])
    ctr_est = torch.round(idx.to(torch.float32) / FRAME_LEN).to(torch.int32)
    pn_table, hop_table = tables["pn_table"], tables["hop_table"]
    band_ids = torch.arange(4, dtype=torch.int32, device=dev)[None, :, None]
    ctr, any_match = _resolve_counters(
        hdr_ok, lo16, ctr_est, hop_table, band_ids, pn_table.shape[0])
    pn_sy = 2.0 * pn_table[ctr.long()].to(torch.float32) - 1.0  # (B,4,P,1024)
    _mark(marks, "header_counter")

    llr = payload_llr(chips, pn_sy)
    _mark(marks, "llr")
    info, crc_ok = hard_decode_batch(llr, polar_spec())
    crc_ok = crc_ok & torch.isfinite(val) & any_match

    # select the first CRC-passing candidate per clip (argmax returns the
    # first maximum) and pack its payload to bytes on the device
    flat_ok = crc_ok.reshape(B, -1)
    best = torch.argmax(flat_ok.to(torch.int32), dim=-1)    # first True
    rows = torch.arange(B, device=dev)
    sel_ok = flat_ok[rows, best]
    sel_info = info.reshape(B, -1, info.shape[-1])[rows, best]
    sel_ctr = ctr.reshape(B, -1)[rows, best]
    pow2 = 2 ** torch.arange(7, -1, -1, dtype=torch.int32, device=dev)
    blob = torch.sum(sel_info.reshape(B, -1, 8) * pow2, dim=-1).to(
        torch.uint8)                                        # (B, 55)
    host_packed = _pack_host_row(sel_ok, sel_ctr, blob)
    _mark(marks, "hard_decode")

    return dict(
        ok=sel_ok, blob=blob, blob_ctr=sel_ctr,
        host_packed=host_packed,   # (B, 60) -- ONE host download
        crc_ok=crc_ok,             # (B, 4, P)
        info_bits=info,            # (B, 4, P, 440)
        ctr=ctr,                   # (B, 4, P)
        hdr_ok=hdr_ok, hdr_score=hdr_score,
        hdr_lo16=lo16,             # (B, 4, P) raw 16-bit header reads
    )


@torch.no_grad()
def _llr_hard_stage(chips: torch.Tensor, pn_sy: torch.Tensor, spec: PolarSpec):
    """(N, 1215) chips + (N, 1024) PN symbols -> hard-decision decode."""
    return hard_decode_batch(payload_llr(chips, pn_sy), spec)


@torch.no_grad()
def _ext_ctr_stage(chips_all, ii, bb, pp, pn_packed, spec: PolarSpec):
    """Extended-counter decode on the device: gather + despread + CRC.

    ``chips_all`` is the (B, 4, P, FRAME_LEN) chip tensor of the verify
    stage; ``pn_packed`` carries each row's payload PN as packed bits
    (MSB-first like np.packbits).  Returns ONE (rows, 1 + info_len/8)
    uint8 row: crc_ok | packed info bits.
    """
    chips = chips_all[ii, bb, pp].to(torch.float32)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=chips.device)
    bits = (pn_packed[:, :, None] >> shifts) & 1
    pn_sy = 2.0 * bits.reshape(pn_packed.shape[0], -1).to(torch.float32) - 1.0
    info, crc_ok = _llr_hard_stage(chips, pn_sy, spec)
    ib = info.reshape(info.shape[0], -1, 8).to(torch.uint8)
    packed = torch.sum(ib << shifts, dim=-1).to(torch.uint8)
    return torch.cat([crc_ok.to(torch.uint8)[:, None], packed], dim=1)


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


def _pack_host_row(sel_ok, sel_ctr, blob):
    """(B,) ok + (B,) int32 ctr + (B, 55) blob -> ONE (B, 60) uint8 row.

    Byte layout: ok(1) | ctr big-endian(4) | blob(55).
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


class BatchVerifier:
    """High-throughput multi-clip verifier (one device stage per batch).

    ``device=None`` means CUDA and raises ``RuntimeError`` without a card;
    pass ``device="cpu"`` to run on the CPU.  Construction sets
    ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False (true float32 products).
    """

    def __init__(self, key32: bytes, *, fs: int = 48_000,
                 max_ctr: int = DEFAULT_MAX_CTR,
                 peaks: int = DEFAULT_PEAKS,
                 accept_legacy_plaintext: bool = False,
                 device: str | torch.device | None = None) -> None:
        device = resolve_device(device)
        sec = SecureChannel(key32)
        hop = hop_schedule(key32)
        self._setup(sec, hop, host_tables(sec, hop, fs, max_ctr), fs=fs,
                    peaks=peaks, accept_legacy_plaintext=accept_legacy_plaintext,
                    device=device)

    @classmethod
    def from_tables(cls, key32: bytes, tables: dict[str, np.ndarray], *,
                    fs: int = 48_000, peaks: int = DEFAULT_PEAKS,
                    accept_legacy_plaintext: bool = False,
                    device: str | torch.device | None = None
                    ) -> "BatchVerifier":
        """A verifier on given numpy tables (e.g. another verifier's)."""
        self = cls.__new__(cls)
        self._setup(SecureChannel(key32), hop_schedule(key32), tables,
                    fs=fs, peaks=peaks,
                    accept_legacy_plaintext=accept_legacy_plaintext,
                    device=resolve_device(device))
        return self

    def _setup(self, sec, hop, tables, *, fs, peaks, accept_legacy_plaintext,
               device) -> None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.fs = fs
        self.sec = sec
        self._hop = hop
        self.peaks = int(peaks)
        self.accept_legacy_plaintext = bool(accept_legacy_plaintext)
        self.device = device
        self._spec = polar_spec()
        self.tables = tables_from_numpy(tables, device)

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
        x = torch.as_tensor(clips, dtype=torch.float32, device=self.device)
        B, T = x.shape
        if n_valid is None:
            n_valid = np.full(B, T, dtype=np.int32)
        nv = torch.as_tensor(n_valid, dtype=torch.int32, device=self.device)
        return _batch_verify_stage(x, nv, self.tables, peaks=self.peaks,
                                   marks=marks)

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
        out = self.run_device(clips, n_valid)
        verdicts, _ = self.finish_host_detailed(
            out, expected_nonce=expected_nonce, details=details)
        # n_valid == 0 rows are padding: they can never verify, so they
        # must not trigger escalation
        real = (torch.as_tensor(n_valid).cpu().numpy() > 0
                if n_valid is not None else np.ones(verdicts.shape, bool))
        pending = real & ~verdicts
        if pending.any():
            verdicts |= self._extended_counter_pass(
                out, pending, expected_nonce, max_stream_frames,
                details=details)
        return verdicts

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
        lo16_or = torch.where(out["hdr_ok"], out["hdr_lo16"], -1).cpu().numpy(
        ).reshape(B, 4, -1)
        hdr_ok = (lo16_or >= 0) & mask[:, None, None]
        ii0, bb0, pp0 = np.nonzero(hdr_ok)            # readable headers
        base = lo16_or[ii0, bb0, pp0].astype(np.int64)
        m = np.arange(n_mult, dtype=np.int64) << 16   # (n_mult,)
        cand = base[:, None] + m[None, :]             # (nh, n_mult)
        ok = (cand >= self.max_ctr) & (cand < max_stream_frames)
        if ok.any():
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
        pn = self.sec.pn_bits_batch(uniq, FRAME_LEN)[:, PRE_L + HDR_L :]
        pnp = np.packbits(pn[inv].astype(np.uint8), axis=-1)
        dev = self.device
        chips_dev = out["chips"].reshape(B, 4, -1, FRAME_LEN)
        host_row = _ext_ctr_stage(
            chips_dev, *(torch.as_tensor(a, dtype=torch.int64, device=dev)
                         for a in (ii, bb, pp)),
            torch.as_tensor(pnp, device=dev), self._spec).cpu().numpy()
        hits = np.flatnonzero(host_row[:, 0] > 0)
        nonces = self._accept_blobs([host_row[r, 1:].tobytes() for r in hits],
                                    ctrs[hits], expected_nonce)
        for r, nonce in zip(hits, nonces):
            i = int(ii[r])
            if nonce is None or rescued[i]:
                continue
            rescued[i] = True
            if details is not None:
                details[i] = ClipDetail(nonce, int(ctrs[r]), "ext_ctr")
        return rescued

    def finish_host(self, out, *,
                    expected_nonce: bytes | None = None) -> np.ndarray:
        """AEAD verdicts from the device outputs (downloads ~60 B/clip)."""
        return self.finish_host_detailed(out, expected_nonce=expected_nonce)[0]

    def finish_host_detailed(self, out, *,
                             expected_nonce: bytes | None = None,
                             details: dict[int, ClipDetail] | None = None):
        """(verdicts (B,) bool, nonces (B,) list[bytes|None]).

        A serving batch mixes clips from many sessions, so the anti-replay
        policy is the CALLER's: pass ``expected_nonce`` to enforce one
        session across the batch, or consume the returned per-clip nonces
        and latch per stream upstream.
        """
        packed = out["host_packed"].cpu().numpy().astype(np.int64)
        ok = packed[:, 0] > 0
        ctrs = ((packed[:, 1] << 24) | (packed[:, 2] << 16)
                | (packed[:, 3] << 8) | packed[:, 4])
        bw = self._spec.info_len // 8
        blobs = packed[:, 5:5 + bw].astype(np.uint8)
        verdicts = np.zeros(ok.shape[0], dtype=bool)
        nonces: list[bytes | None] = [None] * ok.shape[0]
        hits = np.flatnonzero(ok)
        accepted = self._accept_blobs([blobs[i].tobytes() for i in hits],
                                      ctrs[hits], expected_nonce)
        for i, nonce in zip(hits, accepted):
            if nonce is not None:
                verdicts[i] = True
                nonces[i] = nonce
                if details is not None:
                    details[int(i)] = ClipDetail(nonce, int(ctrs[i]), "hard")
        retry = np.flatnonzero(ok & ~verdicts)
        if retry.size:
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
        crc = out["crc_ok"][r].reshape(n, -1).cpu().numpy()
        ctr = out["ctr"][r].reshape(n, -1).cpu().numpy()
        info = out["info_bits"][r].reshape(n, crc.shape[1], -1).to(
            torch.uint8).cpu().numpy()
        crc[np.arange(n), crc.argmax(1)] = False     # the packed row's, tried
        ii, cc = np.nonzero(crc)
        blobs = np.packbits(info[ii, cc], axis=-1)
        accepted = self._accept_blobs([b.tobytes() for b in blobs],
                                      ctr[ii, cc], expected_nonce)
        for i, c, nonce in zip(ii, cc, accepted):
            k = int(rows[i])
            if nonce is None or verdicts[k]:
                continue
            verdicts[k] = True
            nonces[k] = nonce
            if details is not None:
                details[k] = ClipDetail(nonce, int(ctr[i, c]), "hard")

    def _accept_blobs(self, blobs: list[bytes], ctrs: np.ndarray,
                      expected_nonce: bytes | None) -> list[bytes | None]:
        """AEAD open + magic/ctr (+optional nonce) ladder per payload.

        Returns the session nonce of each accepted payload, None elsewhere.
        The reference's "legacy plaintext" acceptance (an unsealed payload
        passing on magic+ctr alone) bypasses AEAD, so it is OFF unless the
        caller opted in at construction.
        """
        out: list[bytes | None] = []
        opened = self.sec.open_any_layout_many(blobs)
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
