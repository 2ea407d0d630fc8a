"""Rational polyphase resampler on tensors (scipy ``resample_poly`` parity).

The batched time-scale recovery ladder (``models/pipeline.py
::RobustBatchVerifier.verify_batch_recover``) corrects recovered clips by
resampling at a rational factor, and ``verify_batch(fs_in=...)`` converts a
capture's rate; both stay on the verifier's device.

"Phase-table" polyphase, not upfirdn: ``resample_poly(x, up, down)`` output
``N = j*up + n`` is a K-tap dot product (K ~ 20*max(1, down/up) + 2 for
scipy's kaiser design: ~22 for upsampling and mild correction factors,
growing with the decimation ratio)

    y[j*up + n] = sum_t  x[j*down + s0 + off[n] + t] * taps[n, t]

where ``off``/``taps`` depend only on the in-block phase ``n``: bandwidth-
bound, no matmul.  On a CUDA device ``resample_batch`` runs it as one
launch of ``csrc/resample.cu`` (each input sample read and each output
written once).  On the CPU its plain version ``_resample_stage`` is one
index lattice ``(n_blocks, up)`` into the zero-padded input, K shifted row
gathers and K fused multiply-adds; the input is padded with zeros on both
sides as far as the lattice reaches, so every read outside it is zero by
construction.

``taps`` is built on the host from the exact FIR scipy designs (firwin,
kaiser beta 5.0, half-length ``10*max(up_r, down_r)`` on the gcd-reduced
ratio) including scipy's pre-pad/trim alignment, so outputs match
``resample_poly`` to float32 rounding.

Shape policy: ``DeviceResampler`` fixes ``up``, the block count and ``K``
for a whole family of ``down``; each ``down`` costs one host FIR design and
one ``(up, K)`` table on the device, cached.  E.g. ``up=12000`` with
``down`` in [11400, 12600] gives every correction factor on an 8.3e-5
grid, inside the v2 demod's ~2e-4 coherence budget.

The reference has no resampling correction at all; the host-side polyphase
path this mirrors is reference utils.py:58-66 (``resample_to``).
"""
from __future__ import annotations

import ctypes
import functools
from math import gcd

import numpy as np
import torch

from echoseal_torch.ops import build

__all__ = ["resample_plan", "resample_rows", "resample_to", "DeviceResampler",
           "resample_batch"]

_PAD_LEFT = 64  # >= |s0| for every supported ratio (checked per plan)
# float32 elements of one per-tap temporary: three such arrays are live
# while a row chunk is resampled (gather, product, accumulator)
DEFAULT_CHUNK_ELEMS = 64 << 20
# ``csrc/resample.cu`` takes up to RESAMPLE_MAX_K taps a phase (K ~ 20 *
# down / up for decimations: a capture of up to about 150 times the output
# rate); both routes refuse more
RESAMPLE_MAX_K = 3072


def resample_to(fs_target: int, audio: np.ndarray, fs_in: int) -> np.ndarray:
    """Host polyphase integer-ratio resampler (reference utils.py:58-66)."""
    x = np.asarray(audio, dtype=np.float32).ravel()
    if fs_in == fs_target or x.size == 0:
        return x
    from scipy.signal import resample_poly

    g = gcd(fs_target, fs_in)
    return resample_poly(x, fs_target // g, fs_in // g).astype(np.float32)


def taps_needed(up: int, down_max: int) -> int:
    """Static tap count covering every ``down <= down_max`` on ``up``.

    scipy's FIR half-length is ``10 * max(up_r, down_r)`` on the reduced
    ratio, so taps-per-phase is bounded by ``20 * max(1, down/up) + 2``
    -- constant (~22) for upsampling and mild correction factors, and
    growing with the decimation ratio for downsampling.
    """
    return int(20 * max(1.0, down_max / up)) + 4


@functools.lru_cache(maxsize=64)
def _design(up_r: int, down_r: int) -> tuple[np.ndarray, int, int]:
    """scipy resample_poly's FIR + alignment for a reduced ratio.

    Returns ``(h, pre_pad, pre_remove)`` exactly as scipy computes them:
    ``y[n] = z[(n + pre_remove) * down_r]`` where ``z`` is the
    zero-stuffed convolution of ``x`` with ``h`` left-padded by
    ``pre_pad`` zeros.
    """
    from scipy.signal import firwin

    if up_r == down_r:
        raise ValueError("resample factor 1.0 is the identity; skip it")
    max_rate = max(up_r, down_r)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate,
               window=("kaiser", 5.0)) * up_r
    pre_pad = down_r - half_len % down_r
    pre_remove = (half_len + pre_pad) // down_r
    return h.astype(np.float64), pre_pad, pre_remove


@functools.lru_cache(maxsize=64)
def resample_plan(up: int, down: int, k_taps: int | None = None
                  ) -> tuple[np.ndarray, np.ndarray, int]:
    """Phase table for ``resample_poly(x, up, down)`` on the ``up`` lattice.

    Returns ``(taps, off, s0)``: float32 ``taps`` of shape
    ``(up, k_taps)`` and int32 ``off`` of shape ``(up,)`` such that

        y[j*up + n] = sum_t x[j*down + s0 + off[n] + t] * taps[n, t]

    with out-of-range input indices reading zero.  ``up``/``down`` need
    not be coprime -- the FIR is designed on the reduced ratio (matching
    scipy's output exactly), then laid out on the caller's lattice so
    one static block size serves a whole factor family.
    """
    g = gcd(up, down)
    up_r, down_r = up // g, down // g
    h, pre_pad, pre_remove = _design(up_r, down_r)
    Lh = h.size
    # Output n of block 0 taps the zero-stuffed lattice at
    #   t_n = (n + pre_remove) * down_r - pre_pad      (reduced units)
    # with y[n] = sum_q x[q] * h[t_n - q*up_r]; nonzero q span
    # [ceil((t_n - Lh + 1)/up_r), floor(t_n/up_r)].  Block j shifts the
    # input window by exactly j*down (up*down_r/up_r = down).
    n = np.arange(up, dtype=np.int64)
    t_n = (n + pre_remove) * down_r - pre_pad
    q_hi = t_n // up_r
    q_lo = -(-(t_n - (Lh - 1)) // up_r)
    n_taps = int((q_hi - q_lo).max()) + 1
    if k_taps is None:
        k_taps = n_taps
    if n_taps > k_taps:
        raise ValueError(f"k_taps={k_taps} < needed {n_taps} "
                         f"for up={up}, down={down}")
    s0 = int(q_lo.min())
    off = (q_lo - s0).astype(np.int32)
    # taps[n, t] multiplies x[q_lo[n] + t]
    tt = np.arange(k_taps, dtype=np.int64)
    idx = t_n[:, None] - (q_lo[:, None] + tt[None, :]) * up_r
    valid = (idx >= 0) & (idx < Lh)
    taps = np.where(valid, h[np.clip(idx, 0, Lh - 1)], 0.0)
    return taps.astype(np.float32), off, s0


@torch.no_grad()
def _resample_stage(x: torch.Tensor, taps: torch.Tensor, off: torch.Tensor,
                    s0: int, down: int, n_out: int, *, n_blocks: int,
                    pad_left: int = _PAD_LEFT,
                    chunk_elems: int = DEFAULT_CHUNK_ELEMS) -> torch.Tensor:
    """(B, T) float32 -> (B, n_blocks*up) resampled, zero past ``n_out``.

    ``taps`` (up, K) and ``off`` (up,) are one plan's tables on ``x``'s
    device.  The input is zero-padded by ``pad_left`` (>= -s0) on the left
    and on the right as far as the last block's last tap reaches, so the
    index lattice never leaves the padded row: reads before the input and
    past it are zeros, and blocks wholly past the input produce zeros.
    Rows are processed in chunks of at most ``chunk_elems`` output
    elements, which bounds the three per-tap temporaries.
    """
    B, T = x.shape
    up, k_taps = taps.shape
    row = n_blocks * up
    base = (torch.arange(n_blocks, device=x.device, dtype=torch.int64)[:, None]
            * down + (s0 + pad_left) + off.to(torch.int64)[None, :]
            ).reshape(-1)                                   # (row,)
    reach = (n_blocks - 1) * down + s0 + pad_left + int(off.max()) + k_taps
    xp = torch.nn.functional.pad(x, (pad_left, max(reach - pad_left - T, 0)))
    y = x.new_empty((B, row))
    step = max(1, min(B, chunk_elems // row))
    for r0 in range(0, B, step):
        xc = xp[r0:r0 + step]
        acc = y[r0:r0 + step].view(-1, n_blocks, up).zero_()
        for t in range(k_taps):
            v = torch.index_select(xc, 1, base + t)
            acc.addcmul_(v.view(-1, n_blocks, up), taps[:, t])
    y[:, n_out:] = 0.0
    return y


@functools.lru_cache(maxsize=1)
def _resample_launcher():
    fn = build.load("resample").resample_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def resample_batch(x: torch.Tensor, rows, taps: torch.Tensor,
                   off: torch.Tensor, s0: int, down: int, n_out: int, *,
                   n_blocks: int, width: int | None = None,
                   pad_left: int = _PAD_LEFT,
                   chunk_elems: int = DEFAULT_CHUNK_ELEMS) -> torch.Tensor:
    """The resample of ``x``'s rows ``rows``: (len(rows), ``width``).

    ``x`` (B, T) float32 with unit stride along T; ``rows`` host indices
    into its rows (a sequence, numpy or CPU tensor; None for all rows, in
    order; repeats allowed); ``taps`` (up, K) float32, ``off`` (up,) int32
    and ``s0`` one plan (``resample_plan``) on ``x``'s device; output
    ``o < n_out`` is ``_resample_stage``'s, the rest zeros, up to ``width``
    (default and at most ``n_blocks * up``).  CUDA tensors go through
    ``csrc/resample.cu``, one launch on the current stream (counted in
    ``build.LAUNCHES["resample"]``), which reads the rows by index and
    writes each output once; CPU tensors through ``_resample_stage`` on
    ``x[rows]`` (``pad_left``, ``chunk_elems`` as it takes them).  Both
    refuse the same inputs, and tensors on another device or on two; there
    is no fallback.
    """
    tensors = (x, taps, off)
    on_cpu = all(t.device.type == "cpu" for t in tensors)
    dev = x.device
    if not on_cpu and (dev.type != "cuda" or
                       any(t.device != dev for t in tensors)):
        raise ValueError(
            "resample: tensors on "
            f"{', '.join(str(t.device) for t in tensors)}; need all on one "
            "CUDA device or all on the CPU")
    if x.dtype != torch.float32 or taps.dtype != torch.float32 or \
            off.dtype != torch.int32:
        raise ValueError(f"resample: dtypes {x.dtype}, {taps.dtype}, "
                         f"{off.dtype}; need float32 x and taps, int32 off")
    B, T = x.shape if x.ndim == 2 else (-1, -1)
    up, K = taps.shape if taps.ndim == 2 else (-1, -1)
    down, n_out = int(down), int(n_out)
    row = n_blocks * up
    width = row if width is None else int(width)
    if x.ndim != 2 or taps.ndim != 2 or off.shape != (up,) or T < 1 or \
            not 1 <= K <= RESAMPLE_MAX_K or down < 1 or \
            not 0 <= width <= row or not 0 <= n_out <= row:
        raise ValueError(
            f"resample: shapes {tuple(x.shape)}, {tuple(taps.shape)}, "
            f"{tuple(off.shape)}, down {down}, n_out {n_out}, width {width}; "
            "need (B, T), (up, K), (up,) with 1 <= K <= "
            f"{RESAMPLE_MAX_K} taps, 0 <= n_out, width <= n_blocks * up")
    if x.stride(-1) != 1 or not taps.is_contiguous() or \
            not off.is_contiguous():
        raise ValueError("resample: x needs unit stride along T, taps and "
                         "off must be contiguous")
    if isinstance(rows, torch.Tensor) and rows.device.type != "cpu":
        raise ValueError("resample: rows must be host indices")
    idx = (np.arange(B, dtype=np.int64) if rows is None
           else np.asarray(rows, dtype=np.int64))
    if idx.ndim != 1 or (idx.size and not 0 <= idx.min() <= idx.max() < B):
        raise ValueError(f"resample: rows must be 1-D indices in [0, {B})")
    if B >= 2 ** 31 or T >= 2 ** 31 or idx.size >= 2 ** 31 or \
            idx.size * -(-width // max(up, 1)) >= 2 ** 30:
        raise ValueError("resample: more than 2**31 - 1 rows or samples")
    if on_cpu:
        xs = x if rows is None else x[torch.from_numpy(idx)]
        return _resample_stage(xs, taps, off, int(s0), down, n_out,
                               n_blocks=n_blocks, pad_left=pad_left,
                               chunk_elems=chunk_elems)[:, :width]
    y = torch.empty((idx.size, width), dtype=torch.float32, device=dev)
    if idx.size == 0 or width == 0:
        return y
    # pinned, so the upload does not wait for the stream's earlier work
    idx_dev = torch.from_numpy(idx).pin_memory().to(dev, non_blocking=True)
    with torch.cuda.device(dev):
        rc = _resample_launcher()(
            x.data_ptr(), x.stride(0), T, idx_dev.data_ptr(), idx.size,
            taps.data_ptr(), off.data_ptr(), up, K, down, int(s0), n_out,
            y.data_ptr(), width, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"resample kernel launch failed: cudaError {rc}")
    build.LAUNCHES["resample"] += 1
    return y


class DeviceResampler:
    """Resampler for a family of ``down`` on one ``up``, one input width.

    >>> rs = DeviceResampler(up=48000, down_min=45600, down_max=50400,
    ...                      t_in=184320, device="cuda")
    >>> y, n_out = rs(clips, down=49488)    # factor 1.031 correction

    ``device`` is the device of the plan tables and of the work; the input
    is moved there.  Per-``down`` cost is one host FIR design plus an
    ``(up, K)`` float32 table on the device, LRU-cached.  On a CUDA device
    each call is one launch of ``csrc/resample.cu``; on the CPU
    ``chunk_elems`` bounds the temporaries (see ``_resample_stage``).
    """

    def __init__(self, up: int, down_min: int, down_max: int, t_in: int, *,
                 device: str | torch.device,
                 chunk_elems: int = DEFAULT_CHUNK_ELEMS) -> None:
        if not (0 < down_min <= down_max):
            raise ValueError("need 0 < down_min <= down_max")
        self.up = int(up)
        self.t_in = int(t_in)
        self.device = torch.device(device)
        self.chunk_elems = int(chunk_elems)
        self.k_taps = taps_needed(self.up, int(down_max))
        # |s0| <= (Lh-1)/up_r + 1 <= k_taps, so this pad always covers the
        # left overhang (checked per plan in _plan_dev)
        self.pad_left = max(_PAD_LEFT, self.k_taps + 8)
        # off.max() <= down + 1 for every admitted factor: the widest
        # window a block may read, checked per plan as well
        self.width = int(down_max) + self.k_taps + self.pad_left
        n_out_max = -(-self.t_in * self.up // int(down_min))
        self.n_blocks = -(-n_out_max // self.up)
        self.down_min, self.down_max = int(down_min), int(down_max)
        # per-factor plan cache holding DEVICE tensors.  LRU-capped: the
        # retry lattice admits up to down_max-down_min+1 distinct
        # denominators (~1.3 GB of tables at up=12000), and a long-lived
        # serving process must not leak device memory to factor churn.
        self._plans: dict[int, tuple] = {}
        self._plans_cap = 256
        self.misses = 0       # plans designed (cache misses), ever

    def _plan_dev(self, down: int):
        plan = self._plans.pop(down, None)
        if plan is None:
            taps, off, s0 = resample_plan(self.up, down, self.k_taps)
            if (s0 < -self.pad_left
                    or int(off.max()) + self.k_taps > self.width):
                raise ValueError(
                    f"plan for down={down} exceeds the family's "
                    f"window (s0={s0}, off_max={int(off.max())})")
            plan = (torch.as_tensor(taps, device=self.device),
                    torch.as_tensor(off, device=self.device), s0)
            while len(self._plans) >= self._plans_cap:
                self._plans.pop(next(iter(self._plans)))
            self.misses += 1
        self._plans[down] = plan          # (re-)insert at LRU tail
        return plan

    def __call__(self, x, down: int, *, rows=None, width: int | None = None
                 ) -> tuple[torch.Tensor, int]:
        """(B, t_in) -> ((len(rows), width) zero past ``n_out``, ``n_out``).

        ``rows`` picks input rows by host index (default all, in order) and
        ``width`` the output columns kept (default and at most
        ``n_blocks * up``); see ``resample_batch``.
        """
        down = int(down)
        if not (self.down_min <= down <= self.down_max):
            raise ValueError(f"down={down} outside the family "
                             f"[{self.down_min}, {self.down_max}]")
        if x.shape[-1] != self.t_in:
            raise ValueError(f"t_in={x.shape[-1]} != {self.t_in}")
        taps_dev, off_dev, s0 = self._plan_dev(down)
        n_out = -(-self.t_in * self.up // down)
        y = resample_batch(
            torch.as_tensor(x, dtype=torch.float32, device=self.device),
            rows, taps_dev, off_dev, s0, down,
            min(n_out, self.n_blocks * self.up), n_blocks=self.n_blocks,
            width=width, pad_left=self.pad_left, chunk_elems=self.chunk_elems)
        return y, n_out


def resample_rows(x: torch.Tensor, up: int, down: int, *,
                  chunk_elems: int = DEFAULT_CHUNK_ELEMS) -> torch.Tensor:
    """One-shot ``resample_poly(x, up, down, axis=-1)`` on ``x``'s device.

    E.g. 44.1 kHz -> 48 kHz batch ingest is ``resample_rows(x, 160, 147)``.
    """
    one = x.ndim == 1
    if one:
        x = x[None]
    rs = DeviceResampler(up, down, down, x.shape[-1], device=x.device,
                         chunk_elems=chunk_elems)
    y, n_out = rs(x, down)
    y = y[..., :n_out]
    return y[0] if one else y
