"""Frozen copy of the plain list-decoder walk of ``echoseal_torch/ops/scl.py``
(``_walk_decode``, ``_scl_decode_plain``; the kernels are not copied) for
the benchmark's plain reference.

CRC-aided successive-cancellation list (SCL) decoding in torch.

The port of ``echoseal_tpu/ops/scl.py``'s exact decoder and of its
fast-SSCL serving mode, both in the structure of its
``_scl_decode_unrolled``: the frozen pattern is static, so the decode tree
is walked on the host once per call and every step is a batched tensor op
over ``(B, L, seg)``:

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
bool array whose column k is the k-th data bit (``spec.data_pos``
ascending): a leaf fork writes its leaf's column.

Numerics follow the JAX package: logaddexp f-combine, "positive LLR =>
bit 1", penalties ``log1p(exp(-|llr|)) (+ |llr| if the decision
disagrees)``, final lists sorted by a stable ascending sort of the
metric.  Every op of the walk is eager, so a decode issues some 10**4
small kernels: it is correct and launch-bound.

The walk is the plain version of the hand-written kernel
``csrc/scl_decode.cu``, the port's counterpart of the JAX package's
one-program ``_scl_decode_unrolled``: on a CUDA tensor every decode is one
launch of it, the exact one (``scl_decode_kernel``, the plain version
``_scl_decode_plain``) along ``node_schedule(spec)`` and the serving one
(``scl_decode_serving_kernel``, the plain version
``_walk_decode(serving=True)``) along ``serving_schedule(spec,
block_seg)``, each the walk's node sequence built once on the host; the
kernel raises outside its domain (1 <= L <= 65536, N <= 1024, CRC-8,
``block_seg`` >= 1).  CPU tensors take the walk.

Serving mode (fast-SSCL, Hashemi et al., "Fast and Flexible
Successive-Cancellation List Decoders", IEEE TSP 2017) is another
algorithm, not a faster route to the same lists: min-sum f-combines and
the hard path metric everywhere, and inside subtrees of at most
``N >> hp`` leaves (``hp`` from ``block_seg`` as in the JAX package)
rate-1 and single-parity-check (SPC) nodes fork only on their
``min(L-1, .)`` least reliable bits.  In the walk such a node's forks
write no decision column; its span's bits are written after it, as the
GF(2) polar transform of its codeword (the kernel tracks no decisions:
u = x G of the root's partial sums gives them all).  ``ECHOSEAL_SCL_IMPL``,
``ECHOSEAL_SCL_SERVING`` and ``ECHOSEAL_SCL_BLOCK_SEG`` choose between the
two at call time (``scl_decode``, ``scl_decode_serving``).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .polar import (
    PolarSpec,
    crc8_check_batch,
    device_tables,
)

BIG_METRIC = 1e30
IMPLS = ("serving", "unrolled", "blocked", "lazy", "dense")
BLOCK_SEG = 16
MAX_LIST = 1 << 16            # the kernel's index maps are 16-bit
MAX_LEVELS = 10                # N <= 1024
# scl_decode.cu's op codes: word = code | level << 4 | side << 8; the last
# two are the serving schedule's node ops
OP_F, OP_G, OP_RATE0, OP_LEAF, OP_REP, OP_COMB, OP_RATE1, OP_SPC = range(8)


@lru_cache(maxsize=None)
def _zero(device: torch.device) -> torch.Tensor:
    return torch.zeros((), device=device)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e**x), computed as ``jnp.logaddexp(x, 0)`` computes it."""
    return torch.logaddexp(x, _zero(x.device))


def _f_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact LLR f-combine: llr of u_left given (a, b)."""
    return torch.logaddexp(a, b) - _softplus(a + b)


def _f_combine_ms(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Min-sum f-combine: -sign(a) sign(b) min(|a|, |b|).

    The leading minus: LLRs here are log p1/p0, under which two confident
    ones combine to a confident zero, so the textbook (log p0/p1) min-sum
    flips sign.
    """
    return -torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())


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


def _penalties_hard(leaf_llr: torch.Tensor):
    """Hard-metric penalties: an agreeing decision is free, a disagreeing
    one costs |llr|; a zero LLR costs nothing either way."""
    mag = torch.abs(leaf_llr)
    pos = leaf_llr >= 0.0
    return torch.where(pos, mag, 0.0), torch.where(pos, 0.0, mag)


def _gf2_transform(beta: torch.Tensor) -> torch.Tensor:
    """The polar kernel over GF(2) on the last axis (a power-of-two width).

    Maps a subtree's codeword (beta) to its leaf bits (u) and back: the
    recursion ``[T(p ^ q), T(q)]`` on halves, done as log2(width) in-place
    butterfly stages on a copy.
    """
    x = beta.clone(memory_format=torch.contiguous_format)
    seg = x.shape[-1]
    h = seg >> 1
    while h:
        v = x.view(*x.shape[:-1], seg // (2 * h), 2, h)
        v[..., 0, :] ^= v[..., 1, :]
        h >>= 1
    return x


def _node_level(n: int, block_seg: int) -> int:
    """The shallowest level whose subtrees may be rate-1 or SPC nodes: the
    JAX package's block-root level ``hp`` for ``block_seg``."""
    N = 1 << n
    ld0 = next((l for l in range(1, n + 1) if (N >> l) <= block_seg), n)
    return max(ld0, 2) - 1


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

    def __init__(self, llr: torch.Tensor, spec: PolarSpec, L: int,
                 serving: bool = False, block_seg: int = BLOCK_SEG) -> None:
        B, N = llr.shape
        dev = llr.device
        self.N, self.n, self.L, self.B = N, N.bit_length() - 1, L, B
        self.frozen = np.asarray(spec.frozen, dtype=bool)
        self.col_of = np.cumsum(~self.frozen) - 1      # leaf -> data column
        self.serving = serving
        self.node_level = _node_level(self.n, block_seg)
        self.f_comb = _f_combine_ms if serving else _f_combine
        self.pens = _penalties_hard if serving else _penalties
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

    def permute(self, pen0: torch.Tensor, pen1: torch.Tensor):
        """2L-candidate fork without a decision column.

        Returns the survivors' bits (B, L) bool and parents (B, L) int64.
        """
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
        self.dec = self.dec[self.rows, parent]
        self.forks += 1
        return bits, parent

    def fork(self, pen0: torch.Tensor, pen1: torch.Tensor,
             leaf: int) -> torch.Tensor:
        """A fork that decides info leaf ``leaf``; returns the bits."""
        bits, _ = self.permute(pen0, pen1)
        self.dec[:, :, int(self.col_of[leaf])] = bits
        return bits

    def write_span(self, pos: int, beta: torch.Tensor) -> None:
        """Write a node's leaf bits, ``_gf2_transform(beta)``, into the
        columns of the span's info leaves."""
        seg = beta.shape[-1]
        info = np.flatnonzero(~self.frozen[pos:pos + seg])
        k0 = int(self.col_of[pos + info[0]])
        u = _gf2_transform(beta)
        self.dec[:, :, k0:k0 + info.size] = (
            u if info.size == seg else u[..., int(info[0]):])

    # ------------------------------------------------------ serving nodes
    def rate1(self, a: torch.Tensor, pos: int) -> torch.Tensor:
        """Rate-1 node: ``min(L-1, seg)`` forks on the least reliable bits,
        each with penalties (0, |a_t|); returns the codeword (beta)."""
        B, L, seg = self.B, self.L, a.shape[-1]
        if L > 1:
            a = a.expand(B, L, seg)
            mag = a.abs()
            q = min(L - 1, seg)
            order = torch.argsort(mag, dim=-1, stable=True)[..., :q]
            beta = self._flip_forks(a, order, mag.gather(-1, order))
        else:
            beta = a > 0.0
        self.write_span(pos, beta)
        return beta

    def spc(self, a: torch.Tensor, pos: int) -> torch.Tensor:
        """SPC node: the parity fixed on the least reliable bit, then
        ``min(L-1, seg-1)`` forks with penalty |a_t| + (1 - 2 f0)|a_0|,
        each flip re-toggling the least reliable bit; returns beta."""
        B, L, seg = self.B, self.L, a.shape[-1]
        q = min(L - 1, seg - 1) if L > 1 else 0
        if q:
            a = a.expand(B, L, seg)
        hard = a > 0.0
        par = hard.sum(dim=-1) & 1                     # (B, L)
        mag = a.abs()
        order = torch.argsort(mag, dim=-1, stable=True)[..., :q + 1]
        smag = mag.gather(-1, order)                   # ascending
        self.metric = self.metric + par.to(torch.float32) * smag[..., 0]
        if q:
            beta = self._flip_forks(a, order, smag, par.bool())
        else:
            beta = hard.scatter(-1, order, hard.gather(-1, order)
                                ^ par.bool()[..., None])
        self.write_span(pos, beta)
        return beta

    def _flip_forks(self, a, order, smag, f0=None):
        """The node's forks, one per order position (an SPC node's parity
        flag ``f0`` stands for position 0, so its forks start at 1).

        The node's alpha, order and sorted magnitudes stay indexed by the
        paths at the node's start: each path carries the index of its
        ancestor there (``anc``), gathered through every fork, together
        with the bits of its flips so far and, for an SPC node, its
        parity flag ``f0`` (the state of the least reliable bit).
        """
        B, L = self.B, self.L
        t0, t1 = (0 if f0 is None else 1), order.shape[-1]
        anc = torch.arange(L, device=a.device).expand(B, L)
        flips = torch.zeros((B, L, t1 - t0), dtype=torch.bool,
                            device=a.device)
        zero = torch.zeros((B, L), device=a.device)
        for t in range(t0, t1):
            pen = smag[..., t].gather(1, anc)
            if f0 is not None:
                pen = pen + (1.0 - 2.0 * f0.to(torch.float32)) * \
                    smag[..., 0].gather(1, anc)
            bits, parent = self.permute(zero, pen)
            anc = anc.gather(1, parent)
            flips = flips[self.rows, parent]
            flips[..., t - t0] = bits
            if f0 is not None:
                f0 = f0.gather(1, parent) ^ bits
        a, order = a[self.rows, anc], order[self.rows, anc]
        if f0 is not None:                             # the least reliable bit
            flips = torch.cat((f0[..., None], flips), dim=-1)
        flip = torch.zeros_like(a, dtype=torch.bool).scatter(-1, order, flips)
        return (a > 0.0) ^ flip

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
            alpha = self.read(a)
            pen = (torch.relu(alpha) if self.serving
                   else _softplus(alpha)).sum(dim=-1)
            self.metric = self.metric + pen
            return None
        if seg == 1:                                   # one info leaf
            bits = self.fork(*self.pens(self.read(a)[..., 0]), pos)
            return self.buf(bits[..., None], bslot)
        if fr[:-1].all():                              # repetition shortcut
            pen0, pen1 = self.pens(self.read(a))
            bits = self.fork(pen0.sum(dim=-1), pen1.sum(dim=-1),
                             pos + seg - 1)
            return self.buf(bits[..., None].expand(-1, -1, seg), bslot)
        if self.serving and l >= self.node_level:
            if not fr.any():
                return self.buf(self.rate1(self.read(a), pos), bslot)
            if fr[0] and not fr[1:].any():
                return self.buf(self.spc(self.read(a), pos), bslot)
        h = seg >> 1
        alpha = self.read(a)
        left = self.walk(l + 1, pos,
                         self.buf(self.f_comb(alpha[..., :h], alpha[..., h:]),
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


def _check_input(llr: torch.Tensor, spec: PolarSpec) -> None:
    if llr.ndim != 2 or llr.shape[1] != spec.N:
        raise ValueError(f"scl_decode: llr of shape {tuple(llr.shape)}; "
                         f"need (B, {spec.N})")
    if not np.array_equal(spec.data_pos, np.flatnonzero(~spec.frozen)):
        raise ValueError("scl_decode: spec.data_pos must be the non-frozen "
                         "leaves in ascending order")


@torch.no_grad()
def _walk_decode(llr: torch.Tensor, spec: PolarSpec, list_size: int, *,
                 serving: bool = False, block_seg: int = BLOCK_SEG):
    """The eager walk, exact or (``serving``) fast-SSCL, on ``llr``'s
    device; see ``scl_decode`` for the arguments and the result."""
    llr = llr.to(torch.float32)
    _check_input(llr, spec)
    dec = _ListDecoder(llr, spec, int(list_size), serving, int(block_seg))
    dec.walk(0, 0, _Buf(llr[:, None, :], 0, 0))

    data = dec.dec.to(torch.int32)
    info = data[..., :spec.info_len]
    crc_ok = crc8_check_batch(info, data[..., spec.info_len:],
                              device_tables(spec, llr.device).crc_mat)
    metric = dec.metric
    order = torch.argsort(metric, dim=-1, stable=True)
    rows = dec.rows
    return {"info_bits": info[rows, order],
            "crc_ok": crc_ok[rows, order],
            "metrics": metric[rows, order]}


def _scl_decode_plain(llr: torch.Tensor, spec: PolarSpec, list_size: int):
    """The exact decode as the eager walk on any device: the plain version
    of ``scl_decode_kernel``."""
    return _walk_decode(llr, spec, list_size)

