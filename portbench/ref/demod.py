"""Frozen copy of ``echoseal_torch/ops/demod.py`` for the benchmark's traffic and
plain reference (it does not move with the program).

Frame demodulation as dense linear algebra (the compat receiver).

Every compat frame is synthesised by zero-state band-pass filtering of
1215 BPSK chips, truncated at the frame boundary, so the observed window
obeys ``y = T c`` with ``T`` a known lower-triangular Toeplitz matrix.
Chips are recovered by Tikhonov-regularised least squares
``c_hat = (T^T T + lam I)^{-1} T^T y = M y`` with ``M`` designed once per
band on the host in float64, then refined by hard projection and greedy
bit-flip descent (see ``refine_chips``).  Two model variants exist:
``direct`` (T from the TX filter alone, window = the 1215 frame samples;
best chip SNR on clean hosts) and ``cascade`` (the stream is band-pass
filtered again at RX and T models the TX*RX cascade, window extended by
``CASCADE_TAIL`` samples; robust to loud out-of-band hosts).  The batch
stage uses the direct model only; the single-clip scan scores both and
lets the FEC decide.  The physics and the measured envelope are
documented in ``echoseal_tpu/ops/demod.py``.

Host designs are numpy; the device pieces are plain torch functions that
run on whatever device their tensors live on.  Every product here is
float32: the lam=1e-12 exact inversion does not survive TF32, so the
verifier turns TF32 off for matmuls and cuDNN convolutions.

Layouts follow the JAX package at every public function; internally the
LS products run band-major, as one batched matmul per band stack
``(F, rows, W) @ (F, W, K)``, so no per-row copy of a 1215x1215 matrix is
ever broadcast into memory.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import scipy.linalg as sla
import torch
import torch.nn.functional as F
from scipy.signal import lfilter

from .bandplan import BAND_PLAN
from .params import FRAME_LEN, HDR_BITS, HDR_L, HDR_REPEAT, PRE_L
from .sequences import bits_to_bpsk, mls63
from . import filters

# Demod window: direct uses the exact frame; cascade appends the RX tail.
CASCADE_TAIL = 512
W_DIRECT = FRAME_LEN
W_CASCADE = FRAME_LEN + CASCADE_TAIL
# lam of the exact-inversion direct profile (the only one the compat
# batch stage uses)
LAM_DIRECT = 1e-12
# Direct-model profiles of the single-clip scan: BOTH use the lam=1e-12
# exact inversion.  Profile 0 is hard-projection REFINED (see
# refine_chips), the hard-decision champion on digital-clean clips;
# profile 1 stays RAW, because the raw LS amplitudes carry the per-chip
# confidence the soft (SCL) pass needs: refinement anchors every chip to
# +-amp, which turns erasures into confidently wrong bits.
LAM_DIRECT_PROFILES = (LAM_DIRECT, LAM_DIRECT)
LAM_CASCADE = 1e-10

# offsets searched around each sync peak (chip-accurate alignment)
SYNC_OFFSETS = (-2, -1, 0, 1, 2)

_IMP_LEN = 8192


# ======================================================================
# host-side designs (numpy, float64 -> float32 constants)
# ======================================================================
@lru_cache(maxsize=32)
def _tx_ir(lo: float, hi: float, fs: int) -> np.ndarray:
    b, a = filters.butter_coeffs(lo, hi, fs)
    imp = np.zeros(_IMP_LEN)
    imp[0] = 1.0
    return lfilter(b, a, imp)


@lru_cache(maxsize=32)
def demod_matrix_direct(lo: float, hi: float, fs: int,
                        lam: float = LAM_DIRECT) -> np.ndarray:
    """(FRAME_LEN, FRAME_LEN) float32 chip-recovery matrix, TX model only."""
    g = _tx_ir(lo, hi, fs)[:FRAME_LEN]
    T = sla.toeplitz(g, np.zeros(FRAME_LEN))
    A = T.T @ T + lam * np.eye(FRAME_LEN)
    M = sla.cho_solve(sla.cho_factor(A), T.T)
    return M.astype(np.float32)


@lru_cache(maxsize=32)
def demod_matrix_cascade(lo: float, hi: float, fs: int,
                         lam: float = LAM_CASCADE,
                         tail: int = CASCADE_TAIL) -> np.ndarray:
    """(FRAME_LEN, FRAME_LEN + tail) float32 matrix for the TX*RX cascade.

    Column j of the model = the RX-filtered version of chip j's TX waveform
    *as truncated at the frame boundary* (the embedder cuts each frame's
    filter tail at 1215 samples before the next frame begins).
    """
    b, a = filters.butter_coeffs(lo, hi, fs)
    g = _tx_ir(lo, hi, fs)
    W = FRAME_LEN + tail
    T = np.zeros((W, FRAME_LEN))
    for j in range(FRAME_LEN):
        tx_col = g[: FRAME_LEN - j]
        T[j:, j] = lfilter(b, a, np.concatenate(
            [tx_col, np.zeros(W - j - tx_col.size)]))
    A = T.T @ T + lam * np.eye(FRAME_LEN)
    M = sla.cho_solve(sla.cho_factor(A), T.T)
    return M.astype(np.float32)


@lru_cache(maxsize=32)
def forward_matrix_direct(lo: float, hi: float, fs: int) -> np.ndarray:
    """(W_DIRECT, FRAME_LEN) float32 forward model T (chips -> window)."""
    g = _tx_ir(lo, hi, fs)[:FRAME_LEN]
    return sla.toeplitz(g, np.zeros(FRAME_LEN)).astype(np.float32)


def all_direct_matrices(fs: int) -> np.ndarray:
    """(4, FRAME_LEN, W_DIRECT) stacked exact-inversion demod matrices."""
    return np.stack(
        [demod_matrix_direct(lo, hi, fs) for lo, hi in BAND_PLAN])


def all_forward_matrices(fs: int) -> np.ndarray:
    """(4, W_DIRECT, FRAME_LEN) stacked forward models."""
    return np.stack(
        [forward_matrix_direct(lo, hi, fs) for lo, hi in BAND_PLAN])


def all_demod_matrices(fs: int) -> tuple[np.ndarray, np.ndarray]:
    """Stacked matrices: (4, P, 1215, W_DIRECT), (4, 1, 1215, W_CASCADE)."""
    md = np.stack([
        np.stack([demod_matrix_direct(lo, hi, fs, lam)
                  for lam in LAM_DIRECT_PROFILES])
        for lo, hi in BAND_PLAN
    ])
    mc = np.stack([
        demod_matrix_cascade(lo, hi, fs)[None] for lo, hi in BAND_PLAN
    ])
    return md, mc


@lru_cache(maxsize=8)
def sync_templates(fs: int) -> np.ndarray:
    """(4, PRE_L) float32 unit-norm singly-filtered MLS templates.

    The stream is correlated raw (no RX refilter) against the TX-filtered
    preamble; correlation itself does the band selection.
    """
    pre = bits_to_bpsk(mls63(), dtype=np.float64)
    out = []
    for lo, hi in BAND_PLAN:
        b, a = filters.butter_coeffs(lo, hi, fs)
        t = lfilter(b, a, pre)
        out.append((t / (np.linalg.norm(t) + 1e-12)).astype(np.float32))
    return np.stack(out)


# ======================================================================
# device-side pipeline pieces (torch, any device)
# ======================================================================
def slice_windows(x: torch.Tensor, starts: torch.Tensor,
                  span: int) -> torch.Tensor:
    """Contiguous windows ``x[..., s : s + span]`` for a start lattice.

    ``x``: (T,) or (B, T); ``starts``: integer with a leading B axis when
    ``x`` is 2-D.  Returns ``starts.shape + (span,)``.  Starts are clamped
    to ``[0, T - span]`` explicitly, NEGATIVE starts included.  The
    windows are read through an ``unfold`` view, one row copy per window.
    """
    starts = starts.to(torch.int64).clamp(0, x.shape[-1] - span)
    view = x.unfold(-1, span, 1)                 # (..., T - span + 1, span)
    if x.ndim == 1:
        return view[starts.reshape(-1)].reshape(*starts.shape, span)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    win = view[rows, starts.reshape(x.shape[0], -1)]
    return win.reshape(*starts.shape, span)


def normalized_xcorr(x: torch.Tensor, templates: torch.Tensor,
                     compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Sliding cosine similarity of ``x`` (..., T) vs (nb, L) templates.

    Returns (..., nb, T - L + 1).  Both the template correlation and the
    sliding-window energy are VALID cross-correlations (``conv1d`` does
    not flip its kernel), in float32.

    ``compute_dtype=torch.bfloat16`` reproduces the JAX package's bf16
    sync: the clip, the templates and x**2 (squared in float32) are
    rounded to bf16, and the products accumulate in float32.  A bf16
    ``conv1d`` would round its output to bf16 too, which is another
    function, so the rounded operands go back to float32 and the conv runs
    in float32 (TF32 off: the product of two bf16 values is exact there).
    """
    nb, L = templates.shape
    lead = x.shape[:-1]
    xr = x.reshape(-1, 1, x.shape[-1])                  # (N, 1, T)
    kern = templates[:, None, :]
    x2 = xr * xr
    if compute_dtype is not None:
        xr, kern, x2 = (t.to(compute_dtype).to(torch.float32)
                        for t in (xr, kern, x2))
    corr = F.conv1d(xr, kern)                           # (N, nb, T-L+1)
    del xr
    ones = torch.ones((1, 1, L), dtype=x2.dtype, device=x.device)
    e2 = F.conv1d(x2, ones)                             # (N, 1, T-L+1)
    del x2
    energy = torch.sqrt(torch.clamp(e2, min=0.0)) + 1e-12
    return corr.div_(energy).reshape(*lead, nb, corr.shape[-1])


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis (kept), as ``jnp.median`` computes it.

    An even-length row gives the mean of its two middle values
    (``torch.median`` would return the lower one).
    """
    n = x.shape[-1]
    v = torch.sort(x, dim=-1).values
    return (0.5 * v[..., (n - 1) // 2] + 0.5 * v[..., n // 2])[..., None]


def cfar_threshold(corr: torch.Tensor) -> torch.Tensor:
    """median + 4.5 * 1.4826 * MAD over the last axis, capped at 0.95."""
    med = _median(corr)
    mad = _median(torch.abs(corr - med)) + 1e-12
    return torch.clamp(med + 4.5 * 1.4826 * mad, max=0.95)[..., 0]


def topk_nms(corr: torch.Tensor, k: int, min_dist: int):
    """Greedy non-max suppression: k exact local maxima, descending value.

    Returns (idx (..., k) int32, val (..., k) float32).  Each iteration
    takes the global argmax (first index on ties) then masks +-min_dist
    around it.  The mask is written into a copy of ``corr`` only over the
    window around each peak (indices clamped into range, which stays
    inside the window), never as a full-size boolean mask.
    """
    c = corr.clone()
    T = c.shape[-1]
    span = torch.arange(-min_dist, min_dist + 1, device=c.device)
    idx, val = [], []
    for _ in range(k):
        i = torch.argmax(c, dim=-1, keepdim=True)               # (..., 1)
        val.append(torch.gather(c, -1, i))
        idx.append(i)
        c.scatter_(-1, (i + span).clamp(0, T - 1), float("-inf"))
    return (torch.cat(idx, -1).to(torch.int32), torch.cat(val, -1))


def gather_windows(x: torch.Tensor, starts: torch.Tensor,
                   width: int) -> torch.Tensor:
    """Gather (N,) start indices -> (N, width) windows from 1-D ``x``.

    Starts are clipped to keep windows in range (callers pad the signal so
    clipping only affects degenerate peaks near the edges).
    """
    return slice_windows(x, starts.reshape(-1), width)


def _band_major(t: torch.Tensor) -> torch.Tensor:
    """(B, F, N, W) -> (F, B*N, W)."""
    return t.transpose(0, 1).reshape(t.shape[1], -1, t.shape[-1])


def _batch_major(t: torch.Tensor, B: int) -> torch.Tensor:
    """(F, B*N, W) -> (B, F, N, W)."""
    return t.reshape(t.shape[0], B, -1, t.shape[-1]).transpose(0, 1)


def demod_chips(windows: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """(B, F, N, W) windows x (F, FRAME_LEN, W) matrices -> (B, F, N, 1215)."""
    return _batch_major(_band_major(windows) @ M.transpose(1, 2),
                        windows.shape[0])


def ls_demod(win: torch.Tensor, m_stack: torch.Tensor) -> torch.Tensor:
    """(B, 4, K, W) windows x (4, NP, C, W) LS stack -> (B, 4, NP, K, C).

    JAX's ``einsum("bfkw,fpcw->bfpkc")`` as ONE band-batched float32
    matmul (4, B*K, W) @ (4, W, NP*C); the stack is read in place, never
    broadcast against the rows.
    """
    B, nb, K, W = win.shape
    _, NP, C, _ = m_stack.shape
    out = _band_major(win) @ m_stack.reshape(nb, NP * C, W).transpose(1, 2)
    return out.reshape(nb, B, K, NP, C).permute(1, 0, 3, 2, 4).contiguous()


def refine_chips(windows: torch.Tensor, chips: torch.Tensor,
                 T_fwd: torch.Tensor, M: torch.Tensor, pre_sy: torch.Tensor,
                 iters: int = 8) -> torch.Tensor:
    """Hard-projection iterative refinement of LS chip estimates.

    Exploits the +-1 alphabet and the known 63-chip preamble: project the
    current estimate to the nearest BPSK sequence (preamble pinned to its
    true symbols), re-synthesise through the forward model, and correct
    with the residual; then a greedy bit-flip descent on the exact
    integer-LS objective walks the last residual chip errors to the ML
    sequence (``echoseal_tpu/ops/demod.py::refine_chips``).

    Shapes: windows (B, F, N, W), chips (B, F, N, FRAME_LEN),
            T_fwd (F, W, FRAME_LEN), M (F, FRAME_LEN, W), band axis F.
    The JAX function broadcasts ``T_fwd[None, :, None]``; here every
    product is one band-batched matmul over all B*N rows.
    """
    B = windows.shape[0]
    win = _band_major(windows)                   # (F, R, W)
    z = _band_major(chips)                       # (F, R, K)
    Tt, Mt = T_fwd.transpose(1, 2), M.transpose(1, 2)

    def project(z):
        c = torch.sign(z)
        c[..., :PRE_L] = pre_sy
        return c, torch.mean(z * c, dim=-1, keepdim=True)

    for _ in range(iters):
        c, amp = project(z)
        ch = c * amp
        z = ch + (win - ch @ Tt) @ Mt

    # ---- greedy bit-flip descent on the exact integer-LS objective ------
    # Flipping chip j changes ||y - amp T c||^2 by
    #   delta_j = 4 amp c_j (T^T r)_j + 4 amp^2 ||t_j||^2 ;
    # repeatedly flip the best j while it improves.
    c, amp = project(z)
    col_n2 = torch.sum(T_fwd * T_fwd, dim=-2)[:, None, :]   # (F, 1, K)
    r = win - (c * amp) @ Tt
    for _ in range(12):
        s = r @ T_fwd                                      # (F, R, K)
        delta = 4.0 * amp * c * s + 4.0 * amp * amp * col_n2
        delta[..., :PRE_L] = float("inf")                  # preamble pinned
        j = torch.argmin(delta, dim=-1, keepdim=True)      # first on ties
        do = (torch.gather(delta, -1, j) < 0.0).to(c.dtype)  # (F, R, 1)
        cj = torch.gather(c, -1, j)
        # c_j -> -c_j where the flip improves (exact: do, c_j are 0/+-1)
        c = c.scatter(-1, j, cj - 2.0 * do * cj)
        # r += 2 amp c_j_old t_j, with t_j = column j of T_fwd (a gather:
        # bit-identical to the JAX one-hot product)
        tj = torch.gather(Tt, 1, j.expand(-1, -1, Tt.shape[-1]))
        r = r + 2.0 * amp * do * cj * tj
    # final soft output: anchored hard decisions + LS residual correction
    ch = c * amp
    z = ch + (win - ch @ Tt) @ Mt
    return _batch_major(z, B)


def preamble_score(chips: torch.Tensor, pre_sy: torch.Tensor) -> torch.Tensor:
    """Cosine of the first 63 recovered chips vs the raw MLS symbols."""
    seg = chips[..., :PRE_L]
    num = seg @ pre_sy
    den = torch.linalg.vector_norm(seg, dim=-1) * np.sqrt(float(PRE_L)) + 1e-12
    return num / den


def header_decode(chips: torch.Tensor, hdr_pn_sy: torch.Tensor):
    """Majority-decode the 16-bit counter header from recovered chips.

    Returns (ok (...,) bool, lo16 (...,) int32, score (...,) float32).
    ``score`` uses the population std (``correction=0``), as ``jnp.std``.
    """
    seg = chips[..., PRE_L : PRE_L + HDR_L]
    d = seg * hdr_pn_sy
    sums = d.reshape(*d.shape[:-1], HDR_BITS, HDR_REPEAT).sum(dim=-1)
    bits = (sums > 0.0).to(torch.int32)
    weights = 2 ** torch.arange(HDR_BITS - 1, -1, -1, dtype=torch.int32,
                                device=chips.device)
    lo16 = torch.sum(bits * weights, dim=-1, dtype=torch.int32)
    rms = torch.sqrt(torch.mean(d * d, dim=-1)) + 1e-12
    mean_abs = torch.mean(torch.abs(sums), dim=-1)
    margin = mean_abs / (rms * HDR_REPEAT)
    score = mean_abs / (torch.std(d, dim=-1, correction=0) + 1e-12)
    return margin > 0.5, lo16, score
