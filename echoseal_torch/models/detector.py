"""Watermark verifier (RX engine), single clip -- the compat tier in torch.

The counterpart of ``echoseal_tpu/models/detector.py``.  The per-clip work
is two device stages plus host-side crypto, run as *staged batched passes*:

  stage S (device)
      4-band sync correlation, CFAR threshold, exact greedy NMS, top-K
      peaks; FFT band filterbank; demodulate every (band, peak,
      alignment-offset) window with the per-band least-squares matrices
      (direct: refined + raw profile; cascade), preamble scores + header
      decode for every candidate at once.
  host
      candidate-counter enumeration with the fallback ladder (header-gated
      +-WIDE with the ``lo16 + m * 2**16`` fan-out, tight +-TIGHT, wide
      +-WIDE, band-gated), round-robin budget, PN keystream fan-out
      (single AES pass).
  stage D (device)
      PN gather + despread + LLR normalisation + hard-decision polar fast
      path with its CRC for ALL candidates at once (the ``payload_decode``
      kernel on the card).
  stage L (device, only if needed)
      SCL list decode over the best candidates, with the retry ladder
      (sign flip, alternate PN convention) as further passes.
  host
      AEAD open with nonce-layout fallbacks + legacy-plaintext acceptance,
      magic/counter checks and the session-nonce anti-replay latch.

The stage outputs stay on the device.  The host downloads only what its
candidate construction reads (peaks, validity, preamble scores, header
reads), gathers the selected chips by index on the device, and uploads
the PN bits of the distinct candidate counters once per pass.

Behavioural contract: clips shorter than 3 s are rejected; ``verify``
returns True on the first authentic frame; the search budgets
``peak_limit`` / ``max_tries`` bound the work.  Device rule:
``device=None`` means CUDA and raises without a card; the CPU only with
``device="cpu"``.  Constructing a detector turns TF32 off for matmuls and
cuDNN (the lam=1e-12 exact inversion does not survive it).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from echoseal_torch.convert import DETECTOR_TABLE_DTYPES, tables_from_numpy
from echoseal_torch.core.bandplan import BAND_PLAN, hop_schedule
from echoseal_torch.core.crypto import SecureChannel
from echoseal_torch.core.device import resolve_device
from echoseal_torch.core.params import (
    FRAME_LEN,
    HDR_L,
    MAGIC,
    MIN_PEAK_FALLBACK,
    N_DEFAULT,
    PEAK_LIMIT,
    PRE_L,
    RxParams,
)
from echoseal_torch.core.sequences import bits_to_bpsk, mls63
from echoseal_torch.ops import demod, filters
from echoseal_torch.ops.llr import payload_decode
from echoseal_torch.ops.polar import pack_info_bits, polar_spec
from echoseal_torch.ops.resample import resample_to  # noqa: F401  (re-export)
from echoseal_torch.ops.scl import scl_decode
from echoseal_torch.utils.logging import Timer, get_logger

MIN_CLIP_SECONDS = 3.0
N_OFFSETS = len(demod.SYNC_OFFSETS)

_LOG = get_logger("rx")

# the stage outputs the host's candidate construction reads
_HOST_KEYS = ("corr_thr", "peak_idx", "peak_valid", "pre_d", "pre_c",
              "hdr_ok_d", "hdr_lo16_d", "hdr_score_d",
              "hdr_ok_c", "hdr_lo16_c", "hdr_score_c")


def _pad_bucket(n: int) -> int:
    """Padded clip length: next power of two, floor 2**17 (~2.7 s).

    Part of the function, not only a shape bucket: the CFAR median and MAD
    run over all ``Tpad - 62`` lags (out-of-range lags count as 0.0) and
    the filterbank's FFT length follows ``Tpad``, so the threshold, hence
    the candidate set, depend on it.
    """
    b = 1 << 17
    while b < n:
        b <<= 1
    return b


# ======================================================================
# device stages
# ======================================================================
def _unit_rms(w: torch.Tensor) -> torch.Tensor:
    """Unit-RMS windows: keeps the float32 demod product's rounding at
    ~1e-4 of the chip amplitude even for the lam=1e-12 exact inversion."""
    return w * torch.rsqrt(torch.mean(w * w, dim=-1, keepdim=True) + 1e-30)


def _profile_demod(win: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(4, N, W) windows x (4, P, K, W) matrices -> (4, P, N, K) chips."""
    return demod.ls_demod(win[None], m)[0]


@torch.no_grad()
def _scan_stage(x: torch.Tensor, n_valid: int,
                tables: dict[str, torch.Tensor],
                peak_limit: int = PEAK_LIMIT) -> dict[str, torch.Tensor]:
    """Sync + filterbank + demod + header for one zero-padded clip.

    ``x``: (Tpad,) float32; ``n_valid``: its true length; ``tables``: the
    detector's device tables (``convert.DETECTOR_TABLE_DTYPES``).  With
    K = ``peak_limit`` peaks per band and O alignment offsets, the
    candidate axis N = K * O is peak-major.
    """
    T = x.shape[-1]
    m_direct, m_cascade = tables["m_direct"], tables["m_cascade"]
    pre_sy, hdr_pn_sy = tables["pre_sy"], tables["hdr_pn_sy"]
    # --- sync: normalized template correlation per band ------------------
    corr = demod.normalized_xcorr(x, tables["templates"])      # (4, T-62)
    # suppress lags whose frame would run past the real clip
    lag = torch.arange(corr.shape[-1], device=x.device)
    corr = corr.masked_fill(lag > (int(n_valid) - FRAME_LEN), float("-inf"))

    finite = torch.where(torch.isfinite(corr), corr, 0.0)
    thr = demod.cfar_threshold(finite)                         # (4,)
    idx, val = demod.topk_nms(corr, peak_limit, FRAME_LEN // 2)   # (4, K)

    above = val >= thr[:, None]
    any_above = torch.any(above, dim=-1, keepdim=True)
    fallback = torch.arange(peak_limit, device=x.device)[None, :] \
        < MIN_PEAK_FALLBACK
    valid = torch.where(any_above, above, fallback) & torch.isfinite(val)

    # --- RX band filterbank (cascade demod source) -----------------------
    fir_bank = tables["fir_bank"]
    nfft = 1 << int(np.ceil(np.log2(T + fir_bank.shape[-1])))
    yf = torch.fft.irfft(torch.fft.rfft(x, nfft)[None, :]
                         * torch.fft.rfft(fir_bank, nfft), nfft)[:, :T]

    # --- gather candidate windows (band, peak, offset) --------------------
    offs = torch.tensor(demod.SYNC_OFFSETS, device=x.device)
    s_flat = (idx[:, :, None] + offs).reshape(4, -1)           # (4, K*O)
    # slice_windows clamps the starts to [0, T - W], negative ones included
    win_d = _unit_rms(demod.slice_windows(x, s_flat, demod.W_DIRECT))
    win_c = _unit_rms(demod.slice_windows(yf, s_flat, demod.W_CASCADE))

    # --- demodulate: one band-batched product per model variant -----------
    chips_d = _profile_demod(win_d, m_direct)                  # (4, P, N, K)
    chips_c = _profile_demod(win_c, m_cascade)                 # (4, 1, N, K)

    # hard-projection refinement on the exact-inversion profile (p=0):
    # +-1 alphabet + known preamble pull residual chip errors to ~0 on
    # clean captures (see ops/demod.refine_chips); profile 1 stays raw
    refined = demod.refine_chips(win_d[None], chips_d[None, :, 0],
                                 tables["t_fwd"], m_direct[:, 0], pre_sy)[0]
    chips_d = torch.cat([refined[:, None], chips_d[:, 1:]], dim=1)

    pre_d = demod.preamble_score(chips_d, pre_sy)              # (4, P, N)
    pre_c = demod.preamble_score(chips_c, pre_sy)
    ok_d, lo16_d, sc_d = demod.header_decode(chips_d, hdr_pn_sy)
    ok_c, lo16_c, sc_c = demod.header_decode(chips_c, hdr_pn_sy)

    return dict(
        corr_thr=thr, peak_idx=idx, peak_val=val, peak_valid=valid,
        chips_d=chips_d, chips_c=chips_c,
        pre_d=pre_d, pre_c=pre_c,
        hdr_ok_d=ok_d, hdr_lo16_d=lo16_d, hdr_score_d=sc_d,
        hdr_ok_c=ok_c, hdr_lo16_c=lo16_c, hdr_score_c=sc_c,
    )


@torch.no_grad()
def _llr_stage(chips: torch.Tensor, pn: torch.Tensor, spec=None, *,
               pn_row: torch.Tensor | None = None, want_llr: bool = True):
    """(N, 1215) chips -> (LLRs or None, info bits, crc_ok).

    ``pn`` is an (M, 1024) {0,1} bit table with ``pn_row`` (N,) the row of
    each candidate, or without ``pn_row`` (N, 1024) +-1 PN symbols, one
    row per candidate.  One ``payload_decode`` launch on the card.
    """
    if pn_row is None:
        pn, pn_row = (pn > 0).to(torch.uint8), torch.arange(
            pn.shape[0], device=pn.device)
    return payload_decode(chips, pn, pn_row, spec or polar_spec(),
                          want_llr=want_llr)


@dataclass
class VerifyResult:
    """Rich verdict for one clip."""

    authentic: bool
    frame_ctr: int | None = None
    band: tuple[int, int] | None = None
    peak_pos: int | None = None
    session_nonce: bytes | None = None
    stage: str | None = None          # 'hard' | 'scl' | '...-alt' | None
    tries: int = 0
    peaks: np.ndarray | None = None   # (4, K) sync peak positions (or -1)
    timescale: float | None = None    # correction factor applied, if any


def host_tables(sec: SecureChannel, fs: int) -> dict[str, np.ndarray]:
    """Every table the single-clip compat stage reads, as numpy arrays."""
    md, mc = demod.all_demod_matrices(fs)
    firs = [filters.fir_from_iir(lo, hi, fs, tol=1e-6) for lo, hi in BAND_PLAN]
    bank = np.zeros((len(firs), max(f.size for f in firs)), np.float32)
    for i, f in enumerate(firs):
        bank[i, : f.size] = f
    return dict(
        templates=demod.sync_templates(fs), m_direct=md, m_cascade=mc,
        t_fwd=demod.all_forward_matrices(fs), fir_bank=bank,
        pre_sy=bits_to_bpsk(mls63()),
        hdr_pn_sy=bits_to_bpsk(sec.pn_bits(0, HDR_L)))


class WatermarkDetector:
    """Public single-clip verifier surface.

    ``device=None`` means CUDA and raises ``RuntimeError`` without a card;
    pass ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, key32: bytes, *, fs_target: int | None = None,
                 list_size: int | None = None,
                 params: RxParams | None = None,
                 device: str | torch.device | None = None) -> None:
        device = resolve_device(device)
        sec = SecureChannel(key32)
        fs = fs_target if fs_target is not None else (
            params or RxParams()).fs_target
        self._setup(key32, sec, host_tables(sec, fs), device,
                    fs_target=fs_target, list_size=list_size, params=params)

    @classmethod
    def from_tables(cls, key32: bytes, tables: dict[str, np.ndarray], *,
                    device: str | torch.device | None = None, **options):
        """A detector on given numpy tables (e.g. another detector's)."""
        self = cls.__new__(cls)
        self._setup(key32, SecureChannel(key32), tables,
                    resolve_device(device), **options)
        return self

    def _setup(self, key32, sec, tables, device, *,
               fs_target: int | None = None, list_size: int | None = None,
               params: RxParams | None = None) -> None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # explicit kwargs win over the params container
        base = params or RxParams()
        over = {k: v for k, v in (("fs_target", fs_target),
                                  ("list_size", list_size)) if v is not None}
        self.p = replace(base, **over) if over else base
        self.sec = sec
        self._hop = hop_schedule(key32)
        self.fs_target = self.p.fs_target
        self.session_nonce: bytes | None = None
        self._spec = polar_spec()
        self._list_size = int(self.p.list_size)
        self.device = device
        self.tables = tables_from_numpy(tables, device, DETECTOR_TABLE_DTYPES)

    # ------------------------------------------------------------------ API
    def verify(self, audio: np.ndarray, fs_in: int) -> bool:
        return self.verify_detailed(audio, fs_in).authentic

    def verify_detailed(self, audio: np.ndarray, fs_in: int) -> VerifyResult:
        signal = resample_to(self.fs_target, audio, fs_in)
        if signal.size < int(MIN_CLIP_SECONDS * self.fs_target):
            return VerifyResult(False, stage=None)
        res = self._verify_signal(signal)
        _LOG.event("verdict", authentic=res.authentic, stage=res.stage,
                   tries=res.tries, ctr=res.frame_ctr)
        return res

    def verify_raw_frame(self, frame: np.ndarray) -> bool:
        """Single synthesized-frame check."""
        x = np.asarray(frame, dtype=np.float32).ravel()
        if x.size < FRAME_LEN:
            return False
        return self._verify_signal(x, assume_start=True).authentic

    # ------------------------------------------------------------ pipeline
    def _candidate_groups(self, out: dict[str, np.ndarray],
                          assume_start: bool) -> list[list[tuple]]:
        """Candidate rows per (band, peak) group, bands in priority order.

        A row is ``(band, (profile, candidate index), counter, source,
        band priority, peak start)`` with source 0 = direct, 1 = cascade;
        every counter of a group contributes one (direct, cascade) pair.
        """
        hop0 = self._hop.index(0)
        band_order = [hop0] + [b for b in range(4) if b != hop0]
        K = out["peak_idx"].shape[1]
        groups: list[list[tuple]] = []
        for pr, b in enumerate(band_order):
            for k in range(K):
                if not out["peak_valid"][b, k]:
                    continue
                rows: list[tuple] = []
                groups.append(rows)
                start = int(out["peak_idx"][b, k])
                # best (profile, offset) by preamble score, per model variant
                base = k * N_OFFSETS
                osl = slice(base, base + N_OFFSETS)
                pd = out["pre_d"][b, :, osl]              # (P, O)
                pc = out["pre_c"][b, :, osl]
                p_d, o_d = np.unravel_index(np.argmax(np.abs(pd)), pd.shape)
                p_c, o_c = np.unravel_index(np.argmax(np.abs(pc)), pc.shape)
                idx_d = (int(p_d), base + int(o_d))
                idx_c = (int(p_c), base + int(o_c))

                ctr_est = int(round(start / FRAME_LEN)) if not assume_start else 0
                hdr_ok = bool(out["hdr_ok_d"][b, idx_d[0], idx_d[1]] or
                              out["hdr_ok_c"][b, idx_c[0], idx_c[1]])
                if (out["hdr_score_d"][b, idx_d[0], idx_d[1]]
                        >= out["hdr_score_c"][b, idx_c[0], idx_c[1]]):
                    lo16 = int(out["hdr_lo16_d"][b, idx_d[0], idx_d[1]])
                else:
                    lo16 = int(out["hdr_lo16_c"][b, idx_c[0], idx_c[1]])

                ctrs: list[int] = []
                lo = max(0, ctr_est - self.p.wide_delta)
                hi = ctr_est + self.p.wide_delta + 1
                if hdr_ok:
                    ctrs = [c for c in range(lo, hi)
                            if (c & 0xFFFF) == lo16 and self._hop.index(c) == b]
                    # absolute resolution: the 16-bit header pins the counter
                    # modulo 2**16.  Coverage is bounded by
                    # RxParams.max_stream_frames: multipliers
                    # m < ceil(max_stream_frames / 2**16) are fanned out.
                    n_mult = -(-self.p.max_stream_frames >> 16)
                    ctrs += [c for c in (lo16 + (m << 16)
                                         for m in range(max(n_mult, 1)))
                             if c not in ctrs and self._hop.index(c) == b]
                if not ctrs:
                    ctrs = [c for c in range(max(0, ctr_est - self.p.tight_delta),
                                             ctr_est + self.p.tight_delta + 1)
                            if self._hop.index(c) == b]
                if not ctrs:
                    ctrs = [c for c in range(lo, hi) if self._hop.index(c) == b]
                for c in ctrs:
                    rows.append((b, idx_d, c, 0, pr, start))
                    rows.append((b, idx_c, c, 1, pr, start))
        return [g for g in groups if g]

    def _budget(self, groups: list[list[tuple]]) -> list[tuple]:
        """Round-robin budget: one (direct, cascade) candidate pair per
        group per cycle, groups kept in band-priority order, so a spurious
        header read on an earlier band cannot evict every candidate of the
        later ones (the ``lo16 + m * 2**16`` fan-out makes single groups
        large)."""
        budget = 2 * self.p.max_tries
        cand_rows: list[tuple] = []
        depth = 0
        while len(cand_rows) < budget:
            took = False
            for g in groups:
                chunk = g[2 * depth : 2 * depth + 2]
                if chunk:
                    took = True
                    cand_rows.extend(chunk)
            if not took:
                break
            depth += 1
        return cand_rows[:budget]

    @torch.no_grad()
    def _verify_signal(self, signal: np.ndarray,
                       assume_start: bool = False) -> VerifyResult:
        dev = self.device
        T = signal.size
        Tpad = _pad_bucket(max(T, FRAME_LEN + demod.W_CASCADE))
        x = np.zeros(Tpad, dtype=np.float32)
        x[:T] = signal

        with Timer("rx.scan_stage"):
            dev_out = _scan_stage(torch.as_tensor(x, device=dev), T,
                                  self.tables, peak_limit=self.p.peak_limit)
            out = {k: dev_out[k].cpu().numpy() for k in _HOST_KEYS}
        _LOG.event("scan", T=T, n_peaks=int(out["peak_valid"].sum()),
                   thr=np.round(out["corr_thr"], 3).tolist())

        # ---------------- candidate construction (host) -------------------
        with Timer("rx.candidates"):
            groups = self._candidate_groups(out, assume_start)
            if not groups:
                return VerifyResult(False, stage=None)
            cand_rows = self._budget(groups)
        bands = np.array([r[0] for r in cand_rows])
        profs = np.array([r[1][0] for r in cand_rows])
        cidx = np.array([r[1][1] for r in cand_rows])
        ctrs = np.array([r[2] for r in cand_rows], dtype=np.int64)
        srcs = np.array([r[3] for r in cand_rows])
        starts = np.array([r[5] for r in cand_rows])
        n_cand = ctrs.size

        def accepted(i: int, nonce: bytes, stage: str, tries: int):
            return VerifyResult(True, frame_ctr=int(ctrs[i]),
                                band=BAND_PLAN[bands[i]],
                                peak_pos=int(starts[i]),
                                session_nonce=nonce, stage=stage, tries=tries)

        # the selected chips, gathered by index on the device
        b_, p_, c_, s_ = torch.as_tensor(
            np.stack([bands, profs, cidx, srcs]), device=dev)
        direct = (s_ == 0)[:, None]
        chips_d, chips_c = dev_out["chips_d"], dev_out["chips_c"]
        cascade = chips_c[b_, torch.clamp(p_, max=chips_c.shape[1] - 1), c_]
        chips = torch.where(direct, chips_d[b_, p_, c_], cascade)
        # The soft pass decodes the RAW LS chips (direct profile 1), not the
        # refined ones: raw amplitudes are per-chip confidences, so weak or
        # erased chips carry low |LLR| and the list decoder forks exactly
        # there.  (Refined chips are anchored to +-amp: ideal for the hard
        # path, information-destroying for a soft decoder.)
        chips_soft = torch.where(
            direct, chips_d[b_, min(1, chips_d.shape[1] - 1), c_], cascade)

        # PN fan-out: one AES pass for every candidate counter, the bits of
        # the distinct counters uploaded once per convention
        with Timer("rx.pn_fanout"):
            uniq, inv = np.unique(ctrs, return_inverse=True)
            inv_dev = torch.as_tensor(inv, device=dev)

            def pn_upload(bits: np.ndarray) -> torch.Tensor:
                return torch.as_tensor(np.ascontiguousarray(bits), device=dev)

            pn_up = pn_upload(
                self.sec.pn_bits_batch(uniq, FRAME_LEN)[:, PRE_L + HDR_L:])

        def hard_pass(info, crc_ok, stage: str):
            """Open the CRC-passing rows in candidate order."""
            hits = torch.nonzero(crc_ok)[:, 0]
            bits = info[hits].to(torch.uint8).cpu().numpy()
            for i, row in zip(hits.tolist(), bits):
                nonce = self._accept(row, int(ctrs[i]))
                if nonce is not None:
                    return accepted(i, nonce, stage, i + 1)
            return None

        # ------------------- hard-decision fast path ----------------------
        with Timer("rx.llr_stage"):
            _, info, crc_ok = _llr_stage(chips, pn_up, self._spec,
                                         pn_row=inv_dev, want_llr=False)
            n_hard = int(crc_ok.sum())
        _LOG.event("llr", n_cand=n_cand, n_hard_crc=n_hard)
        res = hard_pass(info, crc_ok, "hard")
        if res is not None:
            return res

        # --------------------------- SCL pass -----------------------------
        # free extra hard pass over the raw chips (different rounding than
        # the refined pass; occasionally rescues a clean frame on its own)
        llr, info_s, crc_ok_s = _llr_stage(chips_soft, pn_up, self._spec,
                                           pn_row=inv_dev)
        res = hard_pass(info_s, crc_ok_s, "hard")
        if res is not None:
            return res

        # rank candidates by LLR confidence; decode the ladder in batches:
        # +llr, then -llr, then the alternate PN convention (variant 1).
        def scl_pass(llr_src: torch.Tensor, stage: str):
            quality = torch.mean(torch.abs(llr_src), dim=-1).cpu().numpy()
            order = np.argsort(-quality, kind="stable")
            sel = order[: min(self.p.scl_budget, self.p.max_tries, order.size)]
            scl_batch = self.p.scl_batch
            for retry in range(2):  # 0: +llr, 1: -llr
                sign = 1.0 if retry == 0 else -1.0
                for i0 in range(0, sel.size, scl_batch):
                    rows = sel[i0 : i0 + scl_batch]
                    with Timer("rx.scl"):
                        dec = scl_decode(
                            sign * llr_src[torch.as_tensor(rows, device=dev)],
                            self._spec, self._list_size)
                        # (row, list) order, as the paths are opened
                        rr, ll = np.nonzero(dec["crc_ok"].cpu().numpy())
                        bits = dec["info_bits"][
                            torch.as_tensor(rr, device=dev),
                            torch.as_tensor(ll, device=dev)
                        ].to(torch.uint8).cpu().numpy()
                    _LOG.event("scl", rows=int(rows.size), retry=retry,
                               stage=stage, n_crc=int(rr.size))
                    for rloc, row in zip(rr, bits):
                        r = int(rows[rloc])
                        acc = self._accept(row, int(ctrs[r]))
                        if acc is not None:
                            return accepted(r, acc, stage,
                                            int(i0) + int(rloc) + 1)
            return None

        res = scl_pass(llr, "scl")
        if res is not None:
            return res
        # variant 1: PN restarted at the payload
        pn_alt = pn_upload(self.sec.pn_bits_batch(uniq, N_DEFAULT))
        _, info_a, crc_ok_a = _llr_stage(chips, pn_alt, self._spec,
                                         pn_row=inv_dev, want_llr=False)
        res = hard_pass(info_a, crc_ok_a, "hard-alt")
        if res is not None:
            return res
        # the alternate convention goes through the FULL polar decoder
        # including the sign flip, not just the hard path: the same SCL
        # ladder over the alt LLRs of the RAW soft chips
        llr_a, _, _ = _llr_stage(chips_soft, pn_alt, self._spec,
                                 pn_row=inv_dev)
        res = scl_pass(llr_a, "scl-alt")
        if res is not None:
            return res
        return VerifyResult(False, stage=None)

    # ----------------------------------------------------------- host crypto
    def _accept(self, info_bits: np.ndarray, frame_ctr: int) -> bytes | None:
        """AEAD-open + magic/ctr/nonce ladder.  Returns nonce on success."""
        blob = pack_info_bits(info_bits)
        with Timer("rx.aead_open"):
            plain, _layout = self.sec.open_any_layout(blob)
        if plain is None and self.p.accept_legacy_plaintext:
            # legacy plaintext acceptance, gated by RxParams: it bypasses
            # AEAD on a magic+ctr match alone
            plain = blob if blob[:4] == MAGIC else None
        if plain is None or not plain.startswith(MAGIC):
            return None
        if int.from_bytes(plain[4:8], "big") != frame_ctr:
            return None
        nonce = plain[8:16]
        if self.session_nonce is None:
            self.session_nonce = nonce
            return nonce
        return nonce if nonce == self.session_nonce else None
