"""The benchmark's plain reference of the time-scale recovery, in float64.

It imports nothing of the program.  The recovery's three own steps are
computed anew here; each round's verify is ``verify.py``'s:

* the scan: a bank of the frozen v2 sync templates (``v2.py``), each
  resampled by scipy's float64 polyphase ``resample_poly`` for a correction
  factor of the grid, correlated with each clip by a float64 FFT over
  every lag whose window fits the clip; a (clip, bank row)'s score is the
  largest cosine of the window with the row;
* the correction: a float64 polyphase resample at a given rational
  ``up / down`` (scipy's ``resample_poly``, its FIR and its alignment),
  written out as the sum that defines it, on the clips' device;
* each retry round and the first pass: ``verify.py``'s sync, chips,
  decode, AEAD opens and list-decode ladder, on the rows the program
  verified, with the ladder on a given set of rows only.

Every product is float64, which TF32 never touches, whatever the
``torch.backends`` flags say.  The comparison
(``portbench/runners/recover.py``) follows the program:
the scan from the clips alone, then each retry round at the program's
own factors, as ``check.compare`` follows the program's peaks.
"""
from __future__ import annotations

from functools import lru_cache
from math import gcd

import numpy as np
import torch
from scipy.signal import firwin, resample_poly

from . import verify
from .v2 import robust_templates

F64 = torch.float64
# the scan's correction factors: 31 from 0.95 to 1.05, a step of 1/300
GRID = tuple(np.round(np.linspace(0.95, 1.05, 31), 5))


# -------------------------------------------------------------------- scan
@lru_cache(maxsize=4)
def scan_bank(fs: int, S: int) -> np.ndarray:
    """(31 * 4, Lmax) float64 bank, zero past each row: row ``i * 4 + b``
    is band ``b``'s unit-norm template as a clip played ``1 / GRID[i]``
    times as fast shows it (``resample_poly(t, fs, round(fs / GRID[i]))``
    in float64), at unit norm again."""
    base = robust_templates(fs, S).astype(np.float64)
    rows = []
    for r in GRID:
        down = int(round(fs / r))
        g = gcd(fs, down)
        for b in range(4):
            t = resample_poly(base[b], fs // g, down // g)
            rows.append(t / (np.linalg.norm(t) + 1e-12))
    bank = np.zeros((len(rows), max(t.size for t in rows)))
    for i, t in enumerate(rows):
        bank[i, :t.size] = t
    return bank


@torch.no_grad()
def scan_scores(x: torch.Tensor, n_valid: torch.Tensor, bank: torch.Tensor,
                clips: int = 8, rows: int = 32) -> torch.Tensor:
    """(B, R) float64: for each clip and bank row, the largest cosine of a
    bank-row-long window of the clip with the row, over the lags whose
    window ends inside the clip's ``n_valid`` samples."""
    bank = bank.to(F64)
    B, T = x.shape
    R, L = bank.shape
    n_lag = T - L + 1
    Bf = torch.conj(torch.fft.rfft(bank, T))
    lag = torch.arange(n_lag, device=x.device)
    out = torch.empty(B, R, dtype=F64, device=x.device)
    for c0 in range(0, B, clips):
        xc = x[c0:c0 + clips].to(F64)
        e = torch.cumsum(torch.nn.functional.pad(xc * xc, (1, 0)), dim=-1)
        energy = torch.sqrt(torch.clamp(e[:, L:] - e[:, :-L], min=0.0)) \
            + 1e-12
        bad = lag > (n_valid[c0:c0 + clips].to(torch.int64)[:, None] - L)
        X = torch.fft.rfft(xc)
        for r0 in range(0, R, rows):
            corr = torch.fft.irfft(X[:, None] * Bf[None, r0:r0 + rows],
                                   T)[..., :n_lag]
            corr = (corr / energy[:, None]).masked_fill_(bad[:, None],
                                                          float("-inf"))
            out[c0:c0 + clips, r0:r0 + rows] = corr.amax(dim=-1)
            del corr
    return out


def best_factor(scores: torch.Tensor) -> np.ndarray:
    """(B,) index into ``GRID`` of each clip's best factor: the largest
    score over the four bands, the first factor on an exact tie."""
    per = scores.reshape(scores.shape[0], len(GRID), 4).amax(dim=-1)
    return per.argmax(dim=-1).cpu().numpy()


# --------------------------------------------------------------- resample
@lru_cache(maxsize=64)
def _fir(up: int, down: int) -> tuple[np.ndarray, int]:
    """scipy ``resample_poly``'s filter for a reduced ``up / down`` (firwin,
    Kaiser beta 5, half-length 10 * max(up, down), gain ``up``), with its
    zeros in front, and the outputs it drops first."""
    half = 10 * max(up, down)
    h = firwin(2 * half + 1, 1.0 / max(up, down), window=("kaiser", 5.0)) * up
    pre = down - half % down
    return np.concatenate([np.zeros(pre), h]), (half + pre) // down


@torch.no_grad()
def resample(x: torch.Tensor, up: int, down: int, width: int,
             rows: int = 16) -> torch.Tensor:
    """(B, T) -> (B, width) float64 ``resample_poly(x, up, down)`` (zeros
    beyond the input), cut or zero-filled to ``width``: output ``m`` is
    ``sum_j x[j] * h[(m + drop) * down - j * up]`` over the filter's span."""
    g = gcd(up, down)
    up, down = up // g, down // g
    h_np, drop = _fir(up, down)
    h = torch.as_tensor(h_np, dtype=F64, device=x.device)
    B, T = x.shape
    n = min(-(-T * up // down), width)
    t = (torch.arange(n, device=x.device, dtype=torch.int64) + drop) * down
    j_hi = t // up
    taps = -(-h.numel() // up) + 1
    out = torch.zeros(B, width, dtype=F64, device=x.device)
    for r0 in range(0, B, rows):
        xc = x[r0:r0 + rows].to(F64)
        acc = out[r0:r0 + rows, :n]
        for k in range(taps):
            j = j_hi - k
            at = t - j * up
            w = torch.where((at < h.numel()) & (j >= 0) & (j < T),
                            h[at.clamp(max=h.numel() - 1)], 0.0)
            acc += xc[:, j.clamp(0, T - 1)] * w
    return out


# --------------------------------------------------------- one round's verify
@torch.no_grad()
def stage(rows: torch.Tensor, n_valid: torch.Tensor, out: dict, tab: dict,
          peaks: int) -> dict:
    """The reference's stage numbers for one device stage of the program:
    the sync peak values from ``rows`` alone, the chips at the program's
    peaks, and the decode of the program's chips (with its soft rows)."""
    _, val = verify.sync_peaks(rows, n_valid, tab, peaks)
    chips = verify.v2_chips(rows, out["peak_idx"], tab)
    dec = verify.decode(out["chips"], out["peak_idx"], out["peak_val"], tab,
                        soft_rows=out["scl_llr"].shape[1])
    return dict(peak_val=val, chips=chips, dec=dec)


def accepts(dec: dict, out: dict, tab: dict, list_size: int,
            escalate: np.ndarray | None) -> tuple[dict, list]:
    """The verdicts of one round: {row: (nonce, ctr, stage)} and the
    ladder's rungs.  Each row's first CRC-passing candidate that opens (the
    hard pass); then, for the rows of ``escalate`` (None: none) still
    rejected, the futility gate (a readable header, or sync peaks that
    cluster near the stream's start) and the list-decode ladder on the
    program's soft rows."""
    acc = {i: (n, c, "hard")
           for i, (n, c) in verify.hard_verdicts(dec, tab["sec"]).items()}
    if escalate is None:
        return acc, []
    B = dec["crc_ok"].shape[0]
    ok = np.zeros(B, bool)
    ok[list(acc)] = True
    evidence = dec["any_hdr"].cpu().numpy().copy()
    nohdr = escalate & ~ok & ~evidence
    if nohdr.any():
        evidence |= nohdr & verify.near_start_mask(
            out["peak_idx"].cpu().numpy(), out["peak_val"].cpu().numpy(),
            tab["span"])
    pending = escalate & ~ok & evidence
    rungs: list = []
    if pending.any():
        scl, rungs = verify.ladder(out["scl_llr"],
                                   out["scl_ctr"].cpu().numpy(), pending,
                                   list_size, tab)
        acc.update({i: (n, c, "scl") for i, (n, c) in scl.items()})
    return acc, rungs
