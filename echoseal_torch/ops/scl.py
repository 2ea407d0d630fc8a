"""Exact CRC-aided successive-cancellation list (SCL) decoding in torch.

The port of ``echoseal_tpu/ops/scl.py``'s exact decoder, in the structure
of its ``_scl_decode_unrolled``: the frozen pattern is static, so the
decode tree is walked on the host once per call and every step is a
batched tensor op over ``(B, L, seg)``:

* frozen leaves skip the fork (one penalty add);
* aligned all-frozen (rate-0) subtrees collapse to
  ``metric += sum softplus(alpha)``;
* repetition subtrees (all frozen but the last leaf) collapse to ONE
  two-candidate fork with the node-level penalties;
* every other info leaf forks: the 2L candidates, ordered (path0, bit0),
  (path0, bit1), (path1, bit0), ..., are sorted stably and the first L
  survive -- ``lax.top_k``'s "lower index first" on ties, which
  ``torch.topk`` does not promise.

The L paths lie on a batch axis.  A fork moves no alpha or beta buffer:
each live buffer keeps a per-path source-index column, and a fork
permutes those columns (one gather of a (B, L, slots) int64 map).  A
buffer is gathered only when it is read after a fork, so the bytes moved
stay O(N log N) per path.  The decisions ride the forks as a (B, L, K)
bool array: forks happen exactly at the K non-frozen leaves, in ascending
leaf order, so column k is the k-th data bit.

Numerics follow the JAX package: logaddexp f-combine, "positive LLR =>
bit 1", penalties ``log1p(exp(-|llr|)) (+ |llr| if the decision
disagrees)``, final lists sorted by a stable ascending sort of the
metric.  Every op is eager, so a decode issues some 10**4 small kernels:
it is correct and launch-bound.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from echoseal_torch.core.device import resolve_device
from echoseal_torch.ops.polar import PolarSpec, crc8_check_batch

BIG_METRIC = 1e30


@lru_cache(maxsize=None)
def _zero(device: torch.device) -> torch.Tensor:
    return torch.zeros((), device=device)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e**x), computed as ``jnp.logaddexp(x, 0)`` computes it."""
    return torch.logaddexp(x, _zero(x.device))


def _f_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact LLR f-combine: llr of u_left given (a, b)."""
    return torch.logaddexp(a, b) - _softplus(a + b)


def _g_combine(a: torch.Tensor, b: torch.Tensor,
               u_left: torch.Tensor | None) -> torch.Tensor:
    """Exact LLR g-combine ``b + (1 - 2 u) a``; ``u_left`` None means 0."""
    if u_left is None:
        return b + a
    return torch.where(u_left, b - a, b + a)


def _penalties(leaf_llr: torch.Tensor):
    """(pen_bit0, pen_bit1) path-metric penalties for a leaf LLR."""
    mag = torch.abs(leaf_llr)
    soft = torch.log1p(torch.exp(-mag))
    pos = leaf_llr >= 0.0
    return (soft + torch.where(pos, mag, 0.0),
            soft + torch.where(pos, 0.0, mag))


class _Buf:
    """A per-path buffer: its tensor, source-index slot and fork epoch.

    ``t`` is (B, 1, w) while every path shares it (before the first fork)
    or (B, L, w), indexed by the paths as they were at fork ``epoch``.
    """

    __slots__ = ("t", "slot", "epoch")

    def __init__(self, t: torch.Tensor, slot: int, epoch: int) -> None:
        self.t, self.slot, self.epoch = t, slot, epoch


class _ListDecoder:
    """One batched list decode: the walk, the forks and the path state."""

    def __init__(self, llr: torch.Tensor, spec: PolarSpec, L: int) -> None:
        B, N = llr.shape
        dev = llr.device
        self.N, self.n, self.L, self.B = N, N.bit_length() - 1, L, B
        self.frozen = np.asarray(spec.frozen, dtype=bool)
        self.rows = torch.arange(B, device=dev)[:, None]
        metric = torch.full((B, L), BIG_METRIC, device=dev)
        metric[:, 0] = 0.0
        self.metric = metric
        self.dec = torch.zeros((B, L, len(spec.data_pos)), dtype=torch.bool,
                               device=dev)
        # slots: alpha of level l -> l; beta of level l, side s -> n+1+2l+s
        n_slots = 3 * (self.n + 1)
        self.src = torch.arange(L, device=dev)[None, :, None].expand(
            B, L, n_slots)
        self.fresh: set[int] = set()   # slots written since the last fork
        self.forks = 0

    # ------------------------------------------------------- path state
    def buf(self, t: torch.Tensor, slot: int) -> _Buf:
        if t.shape[1] > 1:
            self.fresh.add(slot)
        return _Buf(t, slot, self.forks)

    def read(self, b: _Buf | None) -> torch.Tensor | None:
        """The buffer in the current path order (gathered once per fork)."""
        if b is None or b.t.shape[1] == 1 or b.epoch == self.forks:
            return None if b is None else b.t
        b.t = b.t[self.rows, self.src[:, :, b.slot]]
        b.epoch = self.forks
        self.fresh.add(b.slot)
        return b.t

    def fork(self, pen0: torch.Tensor, pen1: torch.Tensor) -> torch.Tensor:
        """2L-candidate fork; returns the survivors' decisions (B, L) bool."""
        B, L = self.B, self.L
        cand = torch.stack((self.metric + pen0, self.metric + pen1),
                           dim=-1).reshape(B, 2 * L)
        vals, idx = torch.sort(cand, dim=-1, stable=True)
        idx = idx[:, :L]
        parent = idx >> 1
        bits = (idx & 1).bool()
        self.metric = vals[:, :L]
        src = self.src[self.rows, parent]
        if self.fresh:
            src[:, :, sorted(self.fresh)] = parent[..., None]
            self.fresh.clear()
        self.src = src
        dec = self.dec[self.rows, parent]
        dec[:, :, self.forks] = bits
        self.dec = dec
        self.forks += 1
        return bits

    # ------------------------------------------------------------ walk
    def walk(self, l: int, pos: int, a: _Buf) -> _Buf | None:
        """Decode the subtree at level ``l`` from leaf ``pos``.

        ``a`` holds the subtree's alpha (B, ., N >> l); returns its beta
        (partial sums, bool) or None where they are all zero.
        """
        seg = self.N >> l
        fr = self.frozen[pos:pos + seg]
        bslot = self.n + 1 + 2 * l + ((pos >> (self.n - l)) & 1)
        if fr.all():                                   # rate-0 shortcut
            pen = _softplus(self.read(a)).sum(dim=-1)
            self.metric = self.metric + pen
            return None
        if seg == 1:                                   # one info leaf
            bits = self.fork(*_penalties(self.read(a)[..., 0]))
            return self.buf(bits[..., None], bslot)
        if fr[:-1].all():                              # repetition shortcut
            alpha = self.read(a)
            pen0, pen1 = _penalties(alpha)
            bits = self.fork(pen0.sum(dim=-1), pen1.sum(dim=-1))
            return self.buf(bits[..., None].expand(-1, -1, seg), bslot)
        h = seg >> 1
        alpha = self.read(a)
        left = self.walk(l + 1, pos,
                         self.buf(_f_combine(alpha[..., :h], alpha[..., h:]),
                                  l + 1))
        alpha = self.read(a)                           # forks permuted it
        right_a = _g_combine(alpha[..., :h], alpha[..., h:], self.read(left))
        right = self.walk(l + 1, pos + h, self.buf(right_a, l + 1))
        bl, br = self.read(left), self.read(right)
        if bl is None and br is None:
            return None
        if bl is None:
            beta = torch.cat((br, br), dim=-1)
        elif br is None:
            beta = torch.cat((bl, torch.zeros_like(bl)), dim=-1)
        else:
            beta = torch.cat((bl ^ br, br), dim=-1)
        return self.buf(beta, bslot)


@torch.no_grad()
def scl_decode(llr: torch.Tensor, spec: PolarSpec, list_size: int):
    """List-decode a batch of LLR vectors on their device.

    Args:
      llr: (B, N) float32, positive favours bit 1.
      spec: static code structure.
      list_size: number of surviving paths L.

    Returns dict with paths sorted by ascending metric along axis 1:
      info_bits: (B, L, info_len) int32
      crc_ok:    (B, L) bool
      metrics:   (B, L) float32
    """
    llr = llr.to(torch.float32)
    if llr.ndim != 2 or llr.shape[1] != spec.N:
        raise ValueError(f"scl_decode: llr of shape {tuple(llr.shape)}; "
                         f"need (B, {spec.N})")
    if not np.array_equal(spec.data_pos, np.flatnonzero(~spec.frozen)):
        raise ValueError("scl_decode: spec.data_pos must be the non-frozen "
                         "leaves in ascending order")
    dec = _ListDecoder(llr, spec, int(list_size))
    dec.walk(0, 0, _Buf(llr[:, None, :], 0, 0))

    data = dec.dec.to(torch.int32)
    info = data[..., :spec.info_len]
    crc_ok = crc8_check_batch(info, data[..., spec.info_len:], spec.crc_mat)
    metric = dec.metric
    order = torch.argsort(metric, dim=-1, stable=True)
    rows = dec.rows
    return {"info_bits": info[rows, order],
            "crc_ok": crc_ok[rows, order],
            "metrics": metric[rows, order]}


def scl_decode_np(llr: np.ndarray, spec: PolarSpec, list_size: int,
                  device: str | torch.device | None = None):
    """Host entry: (N,) or (B, N) numpy LLRs -> dict of numpy arrays.

    ``device=None`` decodes on the CUDA card (raising without one); pass
    ``device="cpu"`` to decode on the CPU.
    """
    arr = np.asarray(llr, dtype=np.float32)
    squeeze = arr.ndim == 1
    x = torch.as_tensor(arr[None] if squeeze else arr,
                        device=resolve_device(device))
    res = {k: v.cpu().numpy() for k, v in scl_decode(x, spec,
                                                       list_size).items()}
    return {k: v[0] for k, v in res.items()} if squeeze else res
