"""CRC-aided successive-cancellation list (SCL) decoding in torch.

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

import ctypes
import os
from functools import lru_cache

import numpy as np
import torch

from echoseal_torch.core.device import resolve_device
from echoseal_torch.ops import build
from echoseal_torch.ops.polar import (
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


def _scl_decode(llr: torch.Tensor, spec: PolarSpec, list_size: int, *,
                serving: bool = False, block_seg: int = BLOCK_SEG):
    """One list decode: on a CPU tensor the eager walk, on any other one
    launch of the kernel (``scl_decode_kernel``, or
    ``scl_decode_serving_kernel`` for the serving decoder), which raises
    outside its domain."""
    if llr.device.type == "cpu":
        return _walk_decode(llr, spec, list_size, serving=serving,
                            block_seg=block_seg)
    _check_input(llr, spec)
    x = llr.to(torch.float32).contiguous()
    if serving:
        return scl_decode_serving_kernel(x, spec, list_size, block_seg)
    return scl_decode_kernel(x, spec, list_size)


# ------------------------------------------------------------- the kernel
def _op(code: int, level: int, side: int) -> int:
    return code | level << 4 | side << 8


@lru_cache(maxsize=32)
def node_schedule(spec: PolarSpec) -> np.ndarray:
    """The exact walk's node sequence for ``spec`` as ``scl_decode.cu``'s
    int32 op words (``code | level << 4 | side << 8``).

    The order of ``_ListDecoder.walk`` with ``serving=False``: a rate-0
    node (a frozen leaf among them), an info leaf and a repetition node
    are one op each; any other node is f, its left child, g, its right
    child and the combine of the two children's partial sums.  ``side``
    is the node's own side (its parent's left or right child), which
    names the partial-sum slot its result goes to.
    """
    return _walk_schedule(spec, None)


@lru_cache(maxsize=32)
def serving_schedule(spec: PolarSpec, block_seg: int) -> np.ndarray:
    """The serving walk's node sequence for ``spec`` at ``block_seg``, as
    ``node_schedule``'s op words.

    The order of ``_ListDecoder.walk`` with ``serving=True``: rate-0, leaf
    and repetition nodes as in ``node_schedule``; at levels from
    ``_node_level(n, block_seg)`` on, a node with no frozen leaf is one
    ``OP_RATE1`` op and one whose only frozen leaf is its first is one
    ``OP_SPC`` op; f, g and the combine around every other node.
    """
    n = spec.N.bit_length() - 1
    return _walk_schedule(spec, _node_level(n, int(block_seg)))


def _walk_schedule(spec: PolarSpec, level0: int | None) -> np.ndarray:
    """The walk's op words; rate-1 and SPC node ops from ``level0`` on
    (none when it is None)."""
    frozen = np.asarray(spec.frozen, dtype=bool)
    N = frozen.size
    n = N.bit_length() - 1
    ops: list[int] = []

    def walk(l: int, pos: int) -> None:
        seg = N >> l
        fr = frozen[pos:pos + seg]
        side = (pos >> (n - l)) & 1
        node = level0 is not None and l >= level0
        if fr.all():
            ops.append(_op(OP_RATE0, l, side))
        elif seg == 1:
            ops.append(_op(OP_LEAF, l, side))
        elif fr[:-1].all():
            ops.append(_op(OP_REP, l, side))
        elif node and not fr.any():
            ops.append(_op(OP_RATE1, l, side))
        elif node and fr[0] and not fr[1:].any():
            ops.append(_op(OP_SPC, l, side))
        else:
            ops.append(_op(OP_F, l, 0))
            walk(l + 1, pos)
            ops.append(_op(OP_G, l, 0))
            walk(l + 1, pos + seg // 2)
            ops.append(_op(OP_COMB, l, side))

    walk(0, 0)
    return np.asarray(ops, dtype=np.int32)


def schedule_forks(ops: np.ndarray, N: int, list_size: int) -> int:
    """Forks a decode at list size L makes along op words ``ops``: one per
    leaf or repetition node, ``min(L-1, w)`` per rate-1 node of w leaves,
    ``min(L-1, w-1)`` per SPC node."""
    L = int(list_size)
    code, w = ops & 15, N >> ((ops >> 4) & 15)
    return int(np.isin(code, (OP_LEAF, OP_REP)).sum()
               + np.minimum(L - 1, w[code == OP_RATE1]).sum()
               + np.minimum(L - 1, w[code == OP_SPC] - 1).sum())


def _node_span(ops: np.ndarray, N: int) -> int:
    """The widest rate-1 or SPC node's leaves in ``ops`` (1 with none)."""
    code = ops & 15
    node = (code == OP_RATE1) | (code == OP_SPC)
    return int((N >> ((ops[node] >> 4) & 15)).max()) if node.any() else 1


def _schedule(spec: PolarSpec, block_seg: int | None) -> np.ndarray:
    """``node_schedule(spec)``, or ``serving_schedule(spec, block_seg)``
    when ``block_seg`` is given."""
    if block_seg is None:
        return node_schedule(spec)
    return serving_schedule(spec, block_seg)


@lru_cache(maxsize=32)
def device_schedule(spec: PolarSpec, device: torch.device,
                    block_seg: int | None = None) -> torch.Tensor:
    """``_schedule(spec, block_seg)`` on ``device``, uploaded on the first
    call."""
    return torch.as_tensor(_schedule(spec, block_seg), device=device)


@lru_cache(maxsize=32)
def kernel_tables(spec: PolarSpec,
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``scl_decode.cu``'s two int16 tables for ``spec`` on ``device``
    (uploaded on the first call): the info bits' leaf positions, and per
    leaf position what a set bit there adds to the CRC word, the CRC-8 byte
    of an info bit (low byte) or 1 << (8 + c) for the c-th CRC bit, so that
    a codeword passes when the word's two bytes agree."""
    info = spec.info_len
    pos = np.asarray(spec.data_pos, dtype=np.int64)
    cols = spec.crc_mat.astype(np.int64) << np.arange(8)
    tab = np.zeros(spec.N, dtype=np.int64)
    tab[pos[:info]] = np.bitwise_or.reduce(cols, axis=1)
    tab[pos[info:info + 8]] = 1 << (8 + np.arange(spec.crc_size))
    return (torch.as_tensor(pos[:info].astype(np.int16), device=device),
            torch.as_tensor(tab.astype(np.uint16).view(np.int16),
                            device=device))


def bind(lib: ctypes.CDLL) -> tuple:
    """``scl_decode.cu``'s entry points in ``lib`` (the built kernel, or a
    copy of it such as ``tools/scl_trace.py``'s), typed: (plan, workspace,
    launch).  Each takes ``serving``: 0 for the exact decoder, else the
    widest rate-1 or SPC node's leaves (``_node_span``)."""
    for name in ("scl_decode_plan", "scl_decode_workspace"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
    fn = lib.scl_decode_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib.scl_decode_plan, lib.scl_decode_workspace, fn


@lru_cache(maxsize=1)
def _kernel():
    return bind(build.load("scl_decode"))


PLAN_FIELDS = ("threads_per_row", "rows_per_block", "blocks", "sms",
               "smem_per_row", "smem_per_block", "scratch_per_row",
               "slots_in_smem")


def kernel_plan(N: int, list_size: int, rows: int,
                block_seg: int | None = None, spec: PolarSpec | None = None
                ) -> dict:
    """How ``scl_decode_kernel`` (or, given ``block_seg`` and ``spec``,
    ``scl_decode_serving_kernel``) lays out a call of ``rows`` rows of
    length ``N`` at list size L on the current CUDA device
    (``PLAN_FIELDS``; bytes for the memory), plus the SMs the grid
    occupies."""
    plan, _, _ = _kernel()
    serving = 0 if block_seg is None else \
        _node_span(_schedule(spec, block_seg), N)
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    rc = plan(N.bit_length() - 1, int(list_size), int(rows), serving, out)
    if rc != 0:
        raise RuntimeError(f"scl_decode kernel plan failed: cudaError {rc}")
    got = dict(zip(PLAN_FIELDS, out))
    got["sms_used"] = min(got["blocks"], got["sms"])
    return got


def _check_ops(ops: torch.Tensor, device: torch.device, n: int,
               serving: bool = False) -> int:
    """Op words the kernel can follow at 2**n leaves: known codes (the
    rate-1 and SPC node ops only for the serving decoder), levels up to n
    (below n for f, g and a combine, which write level + 1; from 1 to n - 1
    for a node op).  Returns the widest node op's leaves (1 with none)."""
    name = "scl_decode_serving_kernel" if serving else "scl_decode_kernel"
    if ops.device != device or ops.dtype != torch.int32 or \
            not ops.is_contiguous() or ops.ndim != 1:
        raise ValueError(f"{name}: ops must be a contiguous int32 vector on "
                         "the llr's device")
    words = ops.cpu().numpy()
    code, level = words & 15, (words >> 4) & 15
    inner = np.isin(code, (OP_F, OP_G, OP_COMB))
    node = np.isin(code, (OP_RATE1, OP_SPC))
    if (words >> 9).any() or (code > (OP_SPC if serving else OP_COMB)).any() \
            or (level > n).any() or (level[inner] >= n).any() \
            or (level[node] >= n).any() or (level[node] < 1).any():
        raise ValueError(f"{name}: op words out of range")
    return _node_span(words, 1 << n)


def scl_decode_kernel(llr: torch.Tensor, spec: PolarSpec, list_size: int,
                      ops: torch.Tensor | None = None, kernel=None):
    """The exact list decode of ``_scl_decode_plain`` in one launch of
    ``csrc/scl_decode.cu`` (counted in ``build.LAUNCHES["scl_decode"]``).

    ``llr`` (B, N) float32, contiguous, on a CUDA device; N = ``spec.N`` a
    power of two from 2 to 1024; 1 <= ``list_size`` <= 65536 (``MAX_LIST``:
    the 16-bit path maps); a CRC-8 spec.  ``ops`` replaces
    ``node_schedule(spec)`` (an int32 tensor on the same device; a timing
    harness feeds it a run of leaves); ``kernel``, ``bind`` of another build
    of the source (a diagnostic's instrumented copy).  Anything else raises;
    there is no fallback.  Returns ``scl_decode``'s dict.
    """
    return _launch(llr, spec, list_size, None, ops, kernel)


def scl_decode_serving_kernel(llr: torch.Tensor, spec: PolarSpec,
                              list_size: int, block_seg: int = BLOCK_SEG,
                              ops: torch.Tensor | None = None, kernel=None):
    """The fast-SSCL decode of ``_walk_decode(serving=True)`` in one launch
    of ``csrc/scl_decode.cu``'s serving instantiation (counted in
    ``build.LAUNCHES["scl_serving"]``).

    The arguments and the result are ``scl_decode_kernel``'s; the node
    order is ``serving_schedule(spec, block_seg)`` (``block_seg`` >= 1: its
    rate-1 and SPC nodes may span up to N / 2 leaves), which ``ops``
    replaces.  Anything outside the domain raises; there is no fallback.
    """
    if isinstance(block_seg, bool) or \
            not isinstance(block_seg, (int, np.integer)) or block_seg < 1:
        raise ValueError(f"scl_decode_serving_kernel: block_seg "
                         f"{block_seg!r}; need an int >= 1")
    return _launch(llr, spec, list_size, int(block_seg), ops, kernel)


def _launch(llr, spec, list_size, block_seg, ops, kernel):
    """One launch of ``scl_decode.cu``: the exact decoder when
    ``block_seg`` is None, else the serving one at that ``block_seg``."""
    serving = block_seg is not None
    name = "scl_decode_serving_kernel" if serving else "scl_decode_kernel"
    L = int(list_size)
    if not 1 <= L <= MAX_LIST:
        raise ValueError(f"{name}: list size {L}; need 1 to {MAX_LIST}")
    N = spec.N
    n = N.bit_length() - 1
    if llr.ndim != 2 or llr.shape[1] != N or N != 1 << n or \
            not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"{name}: llr of shape {tuple(llr.shape)} for "
                         f"N = {N}; need (B, N) with N a power of two from 2 "
                         f"to {1 << MAX_LEVELS}")
    if spec.crc_size != 8:
        raise ValueError(f"{name}: CRC of {spec.crc_size} bits; need CRC-8")
    if llr.device.type != "cuda":
        raise ValueError(f"{name}: llr on {llr.device}; need a CUDA device")
    if llr.dtype != torch.float32 or not llr.is_contiguous():
        raise ValueError(f"{name}: llr must be contiguous float32")
    B = llr.shape[0]
    if B >= 2 ** 31:
        raise ValueError(f"{name}: more than 2**31 - 1 rows")
    dev = llr.device
    info = torch.empty((B, L, spec.info_len), dtype=torch.int32, device=dev)
    ok = torch.empty((B, L), dtype=torch.bool, device=dev)
    metric = torch.empty((B, L), dtype=torch.float32, device=dev)
    out = {"info_bits": info, "crc_ok": ok, "metrics": metric}
    if ops is None:
        ops = device_schedule(spec, dev, block_seg)
        span = _node_span(_schedule(spec, block_seg), N)
    else:
        span = _check_ops(ops, dev, n, serving)
    mode = span if serving else 0              # the C entry points' serving
    if B == 0:
        return out
    info_pos, crc_tab = kernel_tables(spec, dev)
    _, workspace, launch = kernel or _kernel()
    with torch.cuda.device(dev):
        need = ctypes.c_longlong(0)
        rc = workspace(n, L, B, mode, ctypes.byref(need))
        if rc != 0:
            raise RuntimeError(f"scl_decode kernel plan failed: cudaError {rc}")
        scratch = torch.empty(need.value, dtype=torch.uint8, device=dev)
        rc = launch(llr.data_ptr(), B, n, L, mode, ops.data_ptr(),
                    ops.numel(), info_pos.data_ptr(), crc_tab.data_ptr(),
                    spec.info_len, scratch.data_ptr(), need.value,
                    info.data_ptr(), ok.data_ptr(), metric.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scl_decode kernel launch failed: cudaError {rc}")
    build.LAUNCHES["scl_serving" if serving else "scl_decode"] += 1
    return out


def list_agreement(got: dict, want: dict, tol: float = 1e-4) -> dict:
    """How two decodes of the same rows by the same decoder agree (the
    kernel, exact or serving, against its walk): the kernel's contract, as
    counts.

    ``sets_equal``: every row's set of CRC-passing payloads is the same;
    ``first_pass_equal``: so are the info bits of each row's first
    CRC-passing path; ``metrics_close``: the sorted metrics agree within
    rtol = atol = ``tol``; ``mismatched``: paths that differ (info bits or
    crc_ok) where ``want``'s neighbouring metrics are more than ``tol``
    apart, which the contract allows none of; ``ties``: paths that differ
    beside such a near-equal neighbour (a sum in another float32 order may
    swap them), allowed and counted; ``holds``: the contract is met.
    """
    g = {k: v.cpu() for k, v in got.items()}
    w = {k: v.cpu() for k, v in want.items()}
    m = w["metrics"]
    same = (g["info_bits"] == w["info_bits"]).all(-1) & \
        (g["crc_ok"] == w["crc_ok"])
    near = torch.isclose(m[:, :-1], m[:, 1:], rtol=tol, atol=tol)
    tied = torch.zeros_like(same)
    tied[:, 1:] |= near
    tied[:, :-1] |= near
    packed = {k: np.packbits(r["info_bits"].numpy().astype(np.uint8), -1)
              for k, r in (("g", g), ("w", w))}
    sets_equal = first_equal = True
    for i in range(m.shape[0]):
        ok_g, ok_w = g["crc_ok"][i].numpy(), w["crc_ok"][i].numpy()
        sg = {b.tobytes() for b in packed["g"][i][ok_g]}
        sw = {b.tobytes() for b in packed["w"][i][ok_w]}
        sets_equal &= sg == sw
        if ok_w.any() or ok_g.any():
            first_equal &= bool(ok_w.any() and ok_g.any()) and np.array_equal(
                packed["g"][i][ok_g.argmax()], packed["w"][i][ok_w.argmax()])
    close = bool(torch.isclose(g["metrics"], m, rtol=tol, atol=tol).all())
    mismatched = int((~same & ~tied).sum())
    return {"rows": int(m.shape[0]), "sets_equal": bool(sets_equal),
            "first_pass_equal": bool(first_equal), "metrics_close": close,
            "max_metric_err": float((g["metrics"] - m).abs().max())
            if m.numel() else 0.0,
            "mismatched": mismatched, "ties": int((~same & tied).sum()),
            "crc_pass_rows": int(w["crc_ok"].any(-1).sum()),
            "holds": bool(sets_equal and first_equal and close
                          and mismatched == 0)}


def _block_seg() -> int:
    return int(os.environ.get("ECHOSEAL_SCL_BLOCK_SEG", BLOCK_SEG))


def scl_decode(llr: torch.Tensor, spec: PolarSpec, list_size: int):
    """List-decode a batch of LLR vectors on their device.

    ``ECHOSEAL_SCL_IMPL``, read at each call, picks the decoder:
    ``serving`` the fast-SSCL decoder (at ``ECHOSEAL_SCL_BLOCK_SEG``,
    default 16); ``unrolled``, ``blocked``, ``lazy`` or ``dense``, or unset, the
    exact decoder (the JAX package's four exact formulations give
    identical lists); any other value raises ``ValueError``.

    Args:
      llr: (B, N) float32, positive favours bit 1.
      spec: static code structure.
      list_size: number of surviving paths L.

    Returns dict with paths sorted by ascending metric along axis 1:
      info_bits: (B, L, info_len) int32
      crc_ok:    (B, L) bool
      metrics:   (B, L) float32
    """
    impl = os.environ.get("ECHOSEAL_SCL_IMPL")
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"ECHOSEAL_SCL_IMPL={impl!r}: expected one of "
                         + ", ".join(repr(i) for i in IMPLS))
    if impl == "serving":
        return _scl_decode(llr, spec, list_size, serving=True,
                           block_seg=_block_seg())
    return _scl_decode(llr, spec, list_size)


def scl_decode_serving(llr: torch.Tensor, spec: PolarSpec, list_size: int):
    """List decode entry for the batch ladder.

    ``ECHOSEAL_SCL_IMPL`` wins when it is set (``scl_decode``).  Otherwise
    ``ECHOSEAL_SCL_SERVING`` set to anything but ``""`` or ``"0"`` selects
    the fast-SSCL decoder, and the decode is exact without it.  (The JAX
    package reads any non-empty value, ``"0"`` included, as on.)
    """
    if os.environ.get("ECHOSEAL_SCL_IMPL") is not None:
        return scl_decode(llr, spec, list_size)
    if os.environ.get("ECHOSEAL_SCL_SERVING", "") not in ("", "0"):
        return _scl_decode(llr, spec, list_size, serving=True,
                           block_seg=_block_seg())
    return _scl_decode(llr, spec, list_size)


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
