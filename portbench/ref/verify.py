"""The benchmark's plain reference of the batch verify, in float64.

It imports nothing of the program: every table is designed again here from
the key (frozen copies of the crypto, PN, hop, MLS and filter code beside
this file), every product runs in float64 with plain torch operations, and
the list decoder is the plain eager walk.  What it compares:

* the sync stage, from the clips alone: each (clip, band)'s peak values;
* the demod stage at the program's own peak positions (the stage is
  followed step by step from there, so a tie between two lags cannot
  move every later number): each candidate's chip estimates;
* the decode stage on the program's own chips: each candidate's counter,
  CRC flag and decoded bits, and (v2) each clip's soft rows, LLR by LLR,
  with their counters;
* the verdicts: the first CRC-passing candidate of each clip and its AEAD
  open, the later ones where it fails, and for v2 the futility gate and
  the staged list-decode ladder on the program's soft rows, with the
  CRC-passing paths of each rung.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.signal import lfilter

from . import demod, filters
from .bandplan import BAND_PLAN, hop_schedule
from .crypto import SecureChannel
from .llr import payload_decode_plain
from .params import FRAME_LEN, HDR_L, MAGIC, PRE_L, WIDE_DELTA
from .polar import polar_spec
from .profiles import ROBUST, profile_spec
from .scl import _scl_decode_plain
from .sequences import bits_to_bpsk, mls63
from .v2 import LAM_PROFILES, _chip_pulse

F64 = torch.float64
SCL_LADDER = (8, 32)
NEAR_START_MIN_ALIGNED = 6
NEAR_START_PHASE_TOL = 32


# ----------------------------------------------------------------- tables
def _unit(t: np.ndarray) -> np.ndarray:
    return t / (np.linalg.norm(t) + 1e-12)


def _templates(fs: int, S: int) -> np.ndarray:
    """(4, 63 * S) unit-norm band-filtered (oversampled) MLS templates."""
    pre = np.repeat(bits_to_bpsk(mls63(), dtype=np.float64), S)
    return np.stack([_unit(lfilter(*filters.butter_coeffs(lo, hi, fs), pre))
                     for lo, hi in BAND_PLAN])


def _ls_solve(T: torch.Tensor, lam: float) -> torch.Tensor:
    """(W, C) forward model -> (C, W) Tikhonov LS matrix, by Cholesky."""
    A = T.T @ T + lam * torch.eye(T.shape[1], dtype=F64, device=T.device)
    return torch.cholesky_solve(T.T.contiguous(), torch.linalg.cholesky(A))


def compat_tables(key: bytes, fs: int, max_ctr: int, device) -> dict:
    """Every table of the compat stage, designed anew in float64."""
    sec, hop = SecureChannel(key), hop_schedule(key)
    m, t = [], []
    for lo, hi in BAND_PLAN:
        imp = np.zeros(FRAME_LEN)
        imp[0] = 1.0
        g = torch.as_tensor(lfilter(*filters.butter_coeffs(lo, hi, fs), imp),
                            dtype=F64, device=device)
        i = torch.arange(FRAME_LEN, device=device)
        d = i[:, None] - i[None, :]
        T = torch.where(d >= 0, g[d.clamp(min=0)], 0.0)    # lower Toeplitz
        t.append(T)
        m.append(_ls_solve(T, demod.LAM_DIRECT))
    return dict(_key_tables(sec, hop, max_ctr, device),
                templates=torch.as_tensor(_templates(fs, 1), device=device),
                m_direct=torch.stack(m), t_fwd=torch.stack(t),
                span=FRAME_LEN, spec=polar_spec(), sec=sec)


def v2_tables(key: bytes, fs: int, max_ctr: int, device) -> dict:
    """Every table of the v2 stage, designed anew in float64."""
    sec, hop = SecureChannel(key), hop_schedule(key)
    S, span = ROBUST.oversample, ROBUST.span
    m = []
    for lo, hi in BAND_PLAN:
        g = torch.as_tensor(_chip_pulse(lo, hi, fs, S, span), dtype=F64,
                            device=device)
        r = torch.arange(span, device=device)[:, None]
        c = torch.arange(FRAME_LEN, device=device)[None, :] * S
        T = torch.where(r >= c, g[(r - c).clamp(min=0)], 0.0)   # (span, C)
        m.append(torch.stack([_ls_solve(T, lam) for lam in LAM_PROFILES]))
    return dict(_key_tables(sec, hop, max_ctr, device),
                templates=torch.as_tensor(_templates(fs, S), device=device),
                m_stack=torch.stack(m), span=span,
                spec=profile_spec(ROBUST), sec=sec)


def _key_tables(sec, hop, max_ctr: int, device) -> dict:
    ctrs = np.arange(max_ctr, dtype=np.int64)
    pn = sec.pn_bits_batch(ctrs, FRAME_LEN)[:, PRE_L + HDR_L:]
    return dict(
        pn_table=torch.as_tensor(pn.astype(np.int8), device=device),
        hop_table=torch.as_tensor(hop.indices(ctrs).astype(np.int64),
                                  device=device),
        pre_sy=torch.as_tensor(bits_to_bpsk(mls63(), np.float64),
                               device=device),
        hdr_pn_sy=torch.as_tensor(bits_to_bpsk(sec.pn_bits(0, HDR_L),
                                               np.float64), device=device))


# ------------------------------------------------------------------- sync
@torch.no_grad()
def sync_peaks(x: torch.Tensor, n_valid: torch.Tensor, tab: dict, peaks: int,
               rows: int = 32, rounding=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Float64 FFT cross-correlation, sliding energy and greedy NMS.

    ``x`` (B, T) clips, ``n_valid`` (B,) lengths.  Returns the (B, 4, P)
    peak positions and values, as the stage defines them: the cosine of
    each valid lag's window with the band template, a lag valid while a
    whole frame fits before ``n_valid``, peaks at least span // 2 apart.
    ``rounding`` (the comparison's control) rounds the clip, the templates
    and the squared clip to a lower precision first.
    """
    rnd = rounding or (lambda t: t)
    tmpl, span = rnd(tab["templates"]), tab["span"]
    B, T = x.shape
    L = tmpl.shape[-1]
    n_lag = T - L + 1
    Tf = torch.conj(torch.fft.rfft(tmpl, T))
    lag = torch.arange(n_lag, device=x.device)
    idx, val = [], []
    for r0 in range(0, B, rows):
        xc = x[r0:r0 + rows].to(F64)
        x2 = rnd(xc * xc)
        xc = rnd(xc)
        corr = torch.fft.irfft(torch.fft.rfft(xc)[:, None] * Tf, T)[..., :n_lag]
        e = torch.cumsum(torch.nn.functional.pad(x2, (1, 0)), dim=-1)
        energy = torch.sqrt(torch.clamp(e[:, L:] - e[:, :-L], min=0.0)) + 1e-12
        corr = corr / energy[:, None, :]
        nv = n_valid[r0:r0 + rows].to(torch.int64)
        corr.masked_fill_(lag > (nv[:, None, None] - span), float("-inf"))
        i, v = demod.topk_nms(corr, peaks, span // 2)
        idx.append(i)
        val.append(v)
        del corr, xc, x2, e
    return torch.cat(idx), torch.cat(val)


# ------------------------------------------------------------------ demod
@torch.no_grad()
def compat_chips(x: torch.Tensor, idx: torch.Tensor, tab: dict,
                 rows: int = 256) -> torch.Tensor:
    """Direct LS demod + refinement at each peak's five offsets, the best
    offset by preamble score: (B, 4, P, 1215) float64 chips."""
    out = []
    for r0 in range(0, x.shape[0], rows):
        xb, ib = x[r0:r0 + rows].to(F64), idx[r0:r0 + rows]
        B, T = xb.shape
        P = ib.shape[-1]
        offs = demod.SYNC_OFFSETS
        wide_w = demod.W_DIRECT + max(offs) - min(offs)
        s0 = torch.clamp(ib + min(offs), 0, T - wide_w)
        wide = demod.slice_windows(xb, s0, wide_w)
        win = wide.unfold(-1, demod.W_DIRECT, 1).reshape(B, 4, -1,
                                                         demod.W_DIRECT)
        win = win * torch.rsqrt(torch.mean(win * win, -1, keepdim=True)
                                + 1e-30)
        chips = demod.demod_chips(win, tab["m_direct"])
        chips = demod.refine_chips(win, chips, tab["t_fwd"], tab["m_direct"],
                                   tab["pre_sy"], iters=4)
        pre = demod.preamble_score(chips, tab["pre_sy"]).reshape(
            B, 4, P, len(offs))
        best = torch.argmax(torch.abs(pre), dim=-1)
        flat = torch.arange(P, device=x.device)[None, None, :] * len(offs) \
            + best
        out.append(torch.gather(
            chips.reshape(B, 4, P * len(offs), FRAME_LEN), 2,
            flat[..., None].expand(-1, -1, -1, FRAME_LEN)))
    return torch.cat(out)


@torch.no_grad()
def v2_chips(x: torch.Tensor, idx: torch.Tensor, tab: dict,
             rows: int = 128) -> torch.Tensor:
    """LS demod of the span-long window at each peak against both lam
    profiles: (B, 4, NP, K, 1215) float64 chips."""
    out = []
    for r0 in range(0, x.shape[0], rows):
        win = demod.slice_windows(x[r0:r0 + rows].to(F64), idx[r0:r0 + rows],
                                  tab["span"])
        win = win * torch.rsqrt(torch.mean(win * win, -1, keepdim=True)
                                + 1e-30)
        out.append(demod.ls_demod(win, tab["m_stack"]))
    return torch.cat(out)


# ----------------------------------------------------------------- decode
def _resolve_counters(hdr_ok, lo16, ctr_est, hop_table, band_ids, max_ctr):
    """Header-gated counter, else the nearest counter of the clip's time
    estimate (within WIDE_DELTA) whose hop band is this band."""
    lo16c = torch.clamp(lo16, 0, max_ctr - 1)
    hdr_resolved = hdr_ok & (hop_table[lo16c.long()] == band_ids) & \
        (lo16 < max_ctr)
    deltas = torch.arange(-WIDE_DELTA, WIDE_DELTA + 1, dtype=torch.int32,
                          device=lo16.device)
    cand = torch.clamp(ctr_est[..., None] + deltas, 0, max_ctr - 1)
    match = hop_table[cand.long()] == band_ids[..., None]
    dist = torch.abs(deltas) + torch.where(match, 0, 1 << 20)
    j = torch.argmin(dist, dim=-1, keepdim=True)
    ctr = torch.where(hdr_resolved, lo16c, torch.gather(cand, -1, j)[..., 0])
    return ctr, hdr_resolved | torch.any(match, dim=-1)


@torch.no_grad()
def decode(chips: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
           tab: dict, soft_rows: int = 0, dtype=F64) -> dict:
    """Header, counter, PN, LLR, hard polar decode and CRC of every
    candidate; with ``soft_rows`` each clip's best soft rows too (their
    LLRs and counters, and every row's as ``llr_rows``/``ctr_rows``).
    ``dtype``: the precision of the LLRs (a control's is lower)."""
    chips = chips.to(F64)
    B, P = chips.shape[0], idx.shape[-1]
    lattice = (B, 4) + (1,) * (chips.ndim - 4) + (P,)
    hdr_ok, lo16, _ = demod.header_decode(chips, tab["hdr_pn_sy"])
    ctr_est = torch.round(idx.to(F64) / tab["span"]).to(torch.int32)
    bands = torch.arange(4, device=chips.device).reshape(
        1, 4, *lattice[2:-1], 1)
    ctr, any_match = _resolve_counters(
        hdr_ok, lo16, ctr_est.reshape(lattice), tab["hop_table"], bands,
        tab["pn_table"].shape[0])
    llr, info, crc_ok = payload_decode_plain(chips.to(dtype),
                                             tab["pn_table"], ctr,
                                             tab["spec"], want_llr=True)
    row_ok = torch.isfinite(val).reshape(lattice) & any_match
    out = dict(ctr=ctr, crc_ok=crc_ok & row_ok, info_bits=info,
               any_hdr=torch.any((hdr_ok & row_ok).reshape(B, -1), dim=-1))
    if soft_rows:
        q = torch.where(row_ok, torch.mean(torch.abs(llr), dim=-1),
                        float("-inf")).reshape(B, -1)
        qv, top = torch.sort(q, dim=-1, descending=True, stable=True)
        top = top[:, :soft_rows]
        rows = torch.arange(B, device=chips.device)[:, None]
        ctr_all = ctr.expand(lattice[:2] + chips.shape[2:-1]).reshape(B, -1)
        llr_rows = llr.reshape(B, -1, llr.shape[-1])
        out.update(scl_ctr=ctr_all[rows, top], soft_q=qv[:, :soft_rows],
                   scl_llr=llr_rows[rows, top], llr_rows=llr_rows,
                   ctr_rows=ctr_all)
    return out


# --------------------------------------------------------------- verdicts
def open_blobs(sec, blobs: list[bytes], ctrs) -> list[bytes | None]:
    """AEAD open + magic + counter check: the session nonce, or None."""
    out = []
    for (plain, _), ctr in zip(sec.open_any_layout_many(blobs), ctrs):
        ok = (plain is not None and plain.startswith(MAGIC)
              and int.from_bytes(plain[4:8], "big") == int(ctr))
        out.append(plain[8:16] if ok else None)
    return out


def hard_verdicts(dec: dict, sec) -> dict[int, tuple[bytes, int]]:
    """Each clip's accept from its CRC-passing candidates, in lattice
    order: {clip: (session nonce, counter)}."""
    B = dec["crc_ok"].shape[0]
    crc = dec["crc_ok"].reshape(B, -1).cpu().numpy()
    ctr = dec["ctr"].reshape(B, -1).cpu().numpy()
    info = dec["info_bits"].reshape(B, crc.shape[1], -1)
    acc: dict[int, tuple[bytes, int]] = {}
    while crc.any():                 # each clip's next untried candidate
        ii = np.flatnonzero(crc.any(axis=1))
        cc = crc[ii].argmax(axis=1)
        crc[ii, cc] = False
        bits = info[torch.as_tensor(ii, device=info.device),
                    torch.as_tensor(cc, device=info.device)]
        blobs = np.packbits(bits.to(torch.uint8).cpu().numpy(), axis=-1)
        for i, c, nonce in zip(ii, cc, open_blobs(
                sec, [b.tobytes() for b in blobs], ctr[ii, cc])):
            if nonce is not None:
                acc[int(i)] = (nonce, int(ctr[i, c]))
                crc[i] = False
    return acc


def near_start_mask(idx: np.ndarray, val: np.ndarray, span: int) -> np.ndarray:
    """Clips with no readable header whose sync peaks cluster on one frame
    phase (>= 6 within 32 samples) that starts inside the wide window."""
    idx = idx.reshape(idx.shape[0], -1).astype(np.int64)
    val = val.reshape(idx.shape)
    valid = np.isfinite(val)
    ph = idx % span
    d = np.abs(ph[:, :, None] - ph[:, None, :])
    d = np.minimum(d, span - d)
    pair = (d <= NEAR_START_PHASE_TOL) & valid[:, :, None] & valid[:, None, :]
    cluster = pair.sum(axis=2)
    anchor = np.argmax(cluster, axis=1)
    inside = np.take_along_axis(pair, anchor[:, None, None], axis=1)[:, 0]
    ctr_min = np.where(inside, np.rint(idx / span), np.inf).min(axis=1)
    return (cluster.max(axis=1) >= NEAR_START_MIN_ALIGNED) & \
        (ctr_min < WIDE_DELTA)


def crc_paths(res: dict) -> list[list[bytes]]:
    """Per row, the packed bits of its CRC-passing paths in list order."""
    ok = res["crc_ok"].cpu().numpy()
    info = res["info_bits"].to(torch.uint8).cpu().numpy()
    return [[np.packbits(info[r, l]).tobytes() for l in np.flatnonzero(ok[r])]
            for r in range(ok.shape[0])]


def ladder(scl_llr: torch.Tensor, scl_ctr: np.ndarray, pending: np.ndarray,
           list_size: int, tab: dict) -> tuple[dict, list]:
    """The staged list-decode ladder on given soft rows: each clip's best
    row first, then the rest; the list sizes of ``SCL_LADDER`` below
    ``list_size``, then ``list_size``; each rung only on the clips still
    pending.  Returns ({clip: (nonce, ctr)}, [(rows, L, CRC paths)])."""
    clips = np.flatnonzero(pending)
    acc: dict[int, tuple[bytes, int]] = {}
    rungs = []
    if clips.size == 0:
        return acc, rungs
    dev = scl_llr.device
    llr = scl_llr[torch.as_tensor(clips, device=dev)]
    ctrs = scl_ctr[clips]
    R = llr.shape[1]
    sizes = [s for s in SCL_LADDER if s < list_size] + [list_size]
    left = np.arange(clips.size)
    for lo, hi in ((0, 1), (1, R)):
        for L in sizes:
            if left.size == 0 or lo >= hi:
                continue
            w = hi - lo
            sub = llr[torch.as_tensor(left, device=dev), lo:hi]
            sub_ctr = ctrs[left, lo:hi].reshape(-1)
            paths = crc_paths(_scl_decode_plain(
                sub.reshape(-1, sub.shape[-1]), tab["spec"], L))
            rungs.append((len(sub_ctr), L, paths))
            for r, row in enumerate(paths):
                i = int(clips[left[r // w]])
                for nonce in open_blobs(tab["sec"], row,
                                        [sub_ctr[r]] * len(row)):
                    if nonce is not None and i not in acc:
                        acc[i] = (nonce, int(sub_ctr[r]))
            left = left[[int(clips[j]) not in acc for j in left]]
    return acc, rungs


# ------------------------------------------------ the sync's lower precision
def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round to TF32 (10 mantissa bits, to nearest), as a TF32 product
    rounds its float32 operands."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32).to(t.dtype)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per row (the largest magnitude
    of the row at 448), as an fp8 product would take its operands."""
    s = 448.0 / torch.clamp(t.abs().amax(dim=-1, keepdim=True), min=1e-30)
    return (t * s).to(torch.float8_e4m3fn).to(t.dtype) / s


# ------------------------------------------------------------ single clip
def pad_bucket(n: int) -> int:
    """The single-clip scan's padded length: the next power of two, at
    least 2**17 (the CFAR and the filterbank run over the padding)."""
    b = 1 << 17
    while b < n:
        b <<= 1
    return b


@torch.no_grad()
def single_chips(x: torch.Tensor, idx: torch.Tensor, tab: dict
                 ) -> torch.Tensor:
    """Direct LS demod of one padded clip at each (band, peak) and offset:
    (4, 2, K * 5, 1215) float64 chips, profile 0 refined (8 rounds),
    profile 1 raw, as the single-clip scan keeps them."""
    offs = torch.tensor(demod.SYNC_OFFSETS, device=x.device)
    s = (idx.to(torch.int64)[:, :, None] + offs).reshape(4, -1)
    win = demod.slice_windows(x.to(F64), s, demod.W_DIRECT)
    win = win * torch.rsqrt(torch.mean(win * win, -1, keepdim=True) + 1e-30)
    raw = demod.demod_chips(win[None], tab["m_direct"])[0]        # (4, N, K)
    ref = demod.refine_chips(win[None], raw[None], tab["t_fwd"],
                             tab["m_direct"], tab["pre_sy"])[0]
    return torch.stack([ref, raw], dim=1)
