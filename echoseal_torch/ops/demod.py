"""Frame demodulation as dense linear algebra (the compat receiver).

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

import ctypes
from functools import lru_cache

import numpy as np
import scipy.linalg as sla
import torch
import torch.nn.functional as F
from scipy.signal import lfilter

from echoseal_torch.core.bandplan import BAND_PLAN
from echoseal_torch.core.params import FRAME_LEN, HDR_BITS, HDR_L, HDR_REPEAT, PRE_L
from echoseal_torch.core.sequences import bits_to_bpsk, mls63
from echoseal_torch.ops import build, filters

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


# ----------------------------------------------------- the v2 sync kernel
# Tile decomposition of ``csrc/sync_xcorr.cu``: GEMM row q holds the
# SYNC_LAGS_PER_ROW lags from SYNC_LAGS_PER_ROW * q and reads K samples,
# K = 16 * ceil((L + SYNC_LAGS_PER_ROW - 1) / 16) <= 16 * SYNC_MAX_STEPS.
SYNC_LAGS_PER_ROW = 8
SYNC_MAX_STEPS = 32
SYNC_MAX_L = 16 * SYNC_MAX_STEPS - SYNC_LAGS_PER_ROW + 1


def _sync_depth(L: int) -> int:
    """K: the GEMM depth for templates of length ``L``."""
    return 16 * -(-(L + SYNC_LAGS_PER_ROW - 1) // 16)


def _sync_toeplitz(templates: torch.Tensor) -> torch.Tensor:
    """(K, 5, P) float32: ``B[kappa, b, r] = bf16(tmpl[b, kappa - r])``,
    0 outside [0, L); band 4 is the energy's ones."""
    L = templates.shape[-1]
    P = SYNC_LAGS_PER_ROW
    rows = torch.cat([templates.to(torch.bfloat16).to(torch.float32),
                      torch.ones((1, L), device=templates.device)])
    k = torch.arange(_sync_depth(L), device=templates.device)
    i = k[:, None] - torch.arange(P, device=templates.device)[None, :]
    ok = (i >= 0) & (i < L)
    taps = rows[:, i.clamp(0, L - 1)]                     # (5, K, P)
    return torch.where(ok, taps, 0.0).transpose(0, 1)


def sync_xcorr_plain(x: torch.Tensor, templates: torch.Tensor,
                     n_valid: torch.Tensor, span: int) -> torch.Tensor:
    """The kernel's function in torch ops, along its tile decomposition.

    ``x`` (B, T) float32, ``templates`` (4, L), ``n_valid`` (B,).  Returns
    (B, 4, T - L + 1): ``normalized_xcorr(x, templates, torch.bfloat16)``
    with the lags past ``n_valid - span`` at -inf.  Row q of the GEMM is
    ``x[P q : P q + K]`` (bf16, zero past T), so ``corr[b, P q + r] =
    A[q] @ B[:, b, r]`` (``_sync_toeplitz``); the energy is the same product
    on bf16(x * x) with the ones band.  Rows go 16 at a time, so the
    (rows, Q, K) operands stay near 1.3 GB at the v2 stage's width.
    """
    B, T = x.shape
    L = templates.shape[-1]
    P = SYNC_LAGS_PER_ROW
    n_out = T - L + 1
    K = _sync_depth(L)
    Q = -(-n_out // P)
    toe = _sync_toeplitz(templates)
    w_corr = toe[:, :-1].reshape(K, -1)                  # (K, 4 P)
    w_e2 = toe[:, -1]                                     # (K, P)
    out = torch.empty((B, templates.shape[0], n_out), device=x.device)
    lag = torch.arange(n_out, device=x.device)
    for r0 in range(0, B, 16):
        xc = F.pad(x[r0:r0 + 16], (0, P * (Q - 1) + K - T))
        xb = xc.to(torch.bfloat16).to(torch.float32).unfold(-1, K, P)
        x2 = (xc * xc).to(torch.bfloat16).to(torch.float32).unfold(-1, K, P)
        corr = (xb @ w_corr).reshape(-1, Q, 4, P)        # (R, Q, 4, P)
        e2 = (x2 @ w_e2).reshape(-1, Q * P)[:, :n_out]
        corr = corr.permute(0, 2, 1, 3).reshape(-1, 4, Q * P)[..., :n_out]
        energy = torch.sqrt(torch.clamp(e2, min=0.0)) + 1e-12
        corr = corr / energy[:, None, :]
        bad = lag > (n_valid[r0:r0 + 16, None, None] - span)
        out[r0:r0 + 16] = corr.masked_fill(bad, float("-inf"))
    return out


@lru_cache(maxsize=1)
def _sync_launcher():
    fn = build.load("sync_xcorr").sync_xcorr_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sync_xcorr(x: torch.Tensor, templates: torch.Tensor,
               n_valid: torch.Tensor, span: int) -> torch.Tensor:
    """The v2 batch sync: ``sync_xcorr_plain``'s function, masked lags -inf.

    ``x`` (B, T) float32 with unit stride along T, ``templates`` (4, L)
    float32 contiguous with L <= ``SYNC_MAX_L``, ``n_valid`` (B,) int32 or
    int64, T >= L.  CUDA tensors go through ``csrc/sync_xcorr.cu`` (launched
    on the current stream, counted in ``build.LAUNCHES["sync_xcorr"]``);
    CPU tensors through ``sync_xcorr_plain``.  Anything else raises; there
    is no fallback to ``conv1d``.
    """
    tensors = (x, templates, n_valid)
    if all(t.device.type == "cpu" for t in tensors):
        return sync_xcorr_plain(x, templates, n_valid, span)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "sync_xcorr: tensors on "
            f"{', '.join(str(t.device) for t in tensors)}; need all on one "
            "CUDA device or all on the CPU")
    if x.dtype != torch.float32 or templates.dtype != torch.float32 or \
            n_valid.dtype not in (torch.int32, torch.int64):
        raise ValueError(
            f"sync_xcorr: dtypes {x.dtype}, {templates.dtype}, "
            f"{n_valid.dtype}; need float32 x and templates, int32/int64 "
            "n_valid")
    B, T = x.shape if x.ndim == 2 else (-1, -1)
    L = templates.shape[-1]
    if x.ndim != 2 or templates.shape != (4, L) or \
            not 1 <= L <= SYNC_MAX_L or T < L or n_valid.shape != (B,):
        raise ValueError(
            f"sync_xcorr: shapes {tuple(x.shape)}, {tuple(templates.shape)}, "
            f"{tuple(n_valid.shape)}; need (B, T), (4, L) and (B,) with "
            f"1 <= L <= min(T, {SYNC_MAX_L})")
    if x.stride(-1) != 1 or not templates.is_contiguous() or \
            not n_valid.is_contiguous():
        raise ValueError("sync_xcorr: x needs unit stride along T, "
                         "templates and n_valid must be contiguous")
    if B >= 2 ** 31 or T >= 2 ** 31:
        raise ValueError("sync_xcorr: more than 2**31 - 1 rows or samples")
    out = torch.empty((B, 4, T - L + 1), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        rc = _sync_launcher()(
            x.data_ptr(), x.stride(0), T, templates.data_ptr(), L,
            n_valid.data_ptr(), int(n_valid.dtype == torch.int64), int(span),
            out.data_ptr(), B, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sync_xcorr kernel launch failed: cudaError {rc}")
    build.LAUNCHES["sync_xcorr"] += 1
    return out


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
