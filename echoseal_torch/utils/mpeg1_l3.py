"""MPEG-1 Audio Layer III (MP3) codec (ISO/IEC 11172-3 algorithm), NumPy.

The port's copy of ``echoseal_tpu/utils/mpeg1_l3.py``: a host module
whose bitstreams are byte-identical to the JAX package's.  The Layer III
algorithm end to end, on the same 32-band polyphase filterbank as
utils/mpeg1.py:

* 32-band polyphase analysis/synthesis (shared with utils/mpeg1.py),
* per-subband 36-point **MDCT** with sine window, 50% overlap-add and
  TDAC reconstruction (long blocks),
* the ISO **alias-reduction butterflies** between adjacent subbands
  (the eight ci rotation coefficients of 2.4.3.3.2), applied as the
  inverse rotation at the encoder and the forward rotation at the
  decoder,
* the Layer III **nonuniform power-law quantizer** (|x|^(3/4) with a
  global gain in 2^(1/4) steps and per-scalefactor-band gains in
  2^(1/2) steps, -0.0946 rounding magic, q^(4/3) reconstruction),
* the two nested rate/distortion loops: an inner loop driving
  global_gain to the granule's **Huffman-coded** bit budget, an outer
  loop amplifying scalefactor bands whose quantization noise exceeds
  the psychoacoustic allowance,
* real **Huffman entropy coding** of the spectrum in the Layer III
  region structure -- big-value pairs over three regions with
  per-region table selection + escape/linbits, a {0,1}^4 quadruple
  "count1" region, an implicit all-zero tail -- with canonical code
  tables,
* a real **bit reservoir**: granules borrow unused bits from earlier
  frames up to a 511-byte reservoir cap while the stream stays CBR
  (mean rate enforced by construction, surplus donated or padded).

Deviations from a conformance-grade implementation, stated so nobody
mistakes the claim (same honesty contract as utils/mpeg1.py): the
Huffman tables are canonical codes built in-module from two-sided
geometric symbol priors (the ISO Annex B.7 code tables are not
reproducible in-image) with the real region/escape/linbits/sign
structure; the container is the private echoseal framing rather than
ISO headers + main_data_begin back-pointers (side info is written
inline, the reservoir *accounting* is the real mechanism); long blocks
only (no window switching -- the host classes measured here are not
castanet transients); and the psychoacoustic model is the shared
model-1 family analysis from utils/mpeg1.py rather than model 2.
Streams do not interoperate with consumer decoders, but the
rate/distortion path -- MDCT-domain quantization noise shaped per
scalefactor band by masking, Huffman-coded under a reservoir-managed
constant bitrate -- is the real Layer III algorithm, not a spectral
simulation.
"""
from __future__ import annotations

import functools
import heapq

import numpy as np

from echoseal_torch.data.pqmf512 import DELAY
from echoseal_torch.utils.mpeg1 import (
    FRAME_SAMPLES,
    SUBBANDS,
    _BitReader,
    _BitWriter,
    _global_threshold,
    _psy_consts,
    analyze,
    synthesize,
)

GRANULE = 576                 # spectral lines / granule (18 x 32)
_MAGIC3 = 0x3AD3
_RESERVOIR_MAX = 511 * 8      # ISO main_data_begin reach: 511 bytes
_SF_MAX = 15                  # 4-bit scalefactors (slen <= 4)
_GG_BITS = 9                  # global_gain field width
_FFT_N = 1024

# ---- scalefactor bands, 48 kHz long blocks (ISO Table B.8 family) --------
SFB_EDGES = np.array([0, 4, 8, 12, 16, 20, 24, 30, 36, 42, 50, 60, 72, 88,
                      106, 128, 156, 190, 230, 276, 330, 384, 576])
N_SFB = SFB_EDGES.size - 1    # 22

# ---- alias-reduction rotations (ISO 2.4.3.3.2) ---------------------------
_CI = np.array([-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142,
                -0.0037])
_CS = 1.0 / np.sqrt(1.0 + _CI * _CI)
_CA = _CI * _CS


# ===================== MDCT =================================================

@functools.lru_cache(maxsize=1)
def _mdct_consts():
    n = np.arange(36)
    k = np.arange(18)
    w = np.sin(np.pi * (n + 0.5) / 36.0)
    C = np.cos(np.pi / 72.0 * (2 * n[:, None] + 1 + 18) * (2 * k[None, :] + 1))
    return w, C


def _mdct_granules(s: np.ndarray) -> np.ndarray:
    """(18*G, 32) subband rows -> (G, 576) spectra (granule g overlaps
    granule g-1's rows; the first granule sees a zero history)."""
    w, C = _mdct_consts()
    G = s.shape[0] // 18
    sp = np.concatenate([np.zeros((18, SUBBANDS)), s])      # 18-row history
    out = np.empty((G, GRANULE))
    for g in range(G):
        z = sp[18 * g: 18 * g + 36]                         # (36, 32)
        X = (z * w[:, None]).T @ C                          # (32, 18)
        out[g] = X.reshape(-1)
    return out


def _imdct_granules(X: np.ndarray) -> np.ndarray:
    """(G, 576) spectra -> (18*G, 32) subband rows (TDAC overlap-add).

    Output rows carry the MDCT's 18-row (576-sample) latency; the
    stream DELAY constant accounts for it.
    """
    w, C = _mdct_consts()
    G = X.shape[0]
    acc = np.zeros((18 * G + 18, SUBBANDS))
    for g in range(G):
        z = (X[g].reshape(SUBBANDS, 18) @ C.T).T * w[:, None] * (2.0 / 18.0)
        acc[18 * g: 18 * g + 36] += z
    return acc[:18 * G]


def _alias_reduce(X: np.ndarray, inverse: bool) -> np.ndarray:
    """ISO butterfly rotations across subband seams, whole-granule.

    ``inverse=True`` is the encoder side (rotation transpose), False the
    decoder side; the pair is exactly orthogonal (cs^2 + ca^2 = 1).
    """
    Y = X.copy()
    ca = -_CA if inverse else _CA
    for sb in range(1, SUBBANDS):
        lo = 18 * sb - 1 - np.arange(8)
        hi = 18 * sb + np.arange(8)
        a, b = Y[..., lo].copy(), Y[..., hi].copy()
        Y[..., lo] = a * _CS + b * ca
        Y[..., hi] = b * _CS - a * ca
    return Y


# ===================== Huffman tables ======================================

def _huffman_lengths(weights: list[float]) -> list[int]:
    """Code lengths via the Huffman algorithm, deterministic tie-breaks."""
    n = len(weights)
    if n == 1:
        return [1]
    heap = [(float(weight), i, [i]) for i, weight in enumerate(weights)]
    heapq.heapify(heap)
    lengths = [0] * n
    while len(heap) > 1:
        w1, t1, s1 = heapq.heappop(heap)
        w2, t2, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            lengths[s] += 1
        heapq.heappush(heap, (w1 + w2, min(t1, t2), s1 + s2))
    return lengths


def _canonical_codes(lengths: list[int]) -> list[int]:
    """Canonical code values: sorted by (length, symbol index)."""
    order = sorted(range(len(lengths)), key=lambda s: (lengths[s], s))
    codes = [0] * len(lengths)
    code, prev_len = 0, 0
    for s in order:
        code <<= lengths[s] - prev_len
        codes[s] = code
        prev_len = lengths[s]
        code += 1
    return codes


class _PairTable:
    """Big-value pair table: symbols (x, y) in [0..max]^2 (+ linbits)."""

    def __init__(self, max_v: int, linbits: int, decay: float) -> None:
        self.max = max_v
        self.linbits = linbits
        m = max_v + 1
        weights = [decay ** (x + y) for x in range(m) for y in range(m)]
        lens = _huffman_lengths(weights)
        codes = _canonical_codes(lens)
        self.len = np.array(lens).reshape(m, m)
        self.code = np.array(codes).reshape(m, m)
        # decode tree as {prefix_bits: symbol}
        self.tree: dict[tuple[int, int], tuple[int, int]] = {}
        for x in range(m):
            for y in range(m):
                self.tree[(int(self.len[x, y]), int(self.code[x, y]))] = (x, y)


# table classes: (max value, linbits).  The last is the escape table.
_PAIR_SPECS = ((1, 0), (2, 0), (3, 0), (5, 0), (7, 0), (15, 13))
_PAIR_DECAY = 0.45


@functools.lru_cache(maxsize=1)
def _pair_tables() -> tuple[_PairTable, ...]:
    return tuple(_PairTable(m, lb, _PAIR_DECAY) for m, lb in _PAIR_SPECS)


class _QuadTable:
    """count1 table: symbols (v,w,x,y) in {0,1}^4."""

    def __init__(self, decay: float) -> None:
        weights = [decay ** bin(s).count("1") for s in range(16)]
        lens = _huffman_lengths(weights)
        codes = _canonical_codes(lens)
        self.len = np.array(lens)
        self.code = np.array(codes)
        self.tree = {(int(self.len[s]), int(self.code[s])): s
                     for s in range(16)}


@functools.lru_cache(maxsize=1)
def _quad_tables() -> tuple[_QuadTable, ...]:
    # two priors like the ISO pair: sparse-biased and near-uniform
    return (_QuadTable(0.4), _QuadTable(0.9))


# region0/region1 extents in scalefactor bands (fixed split; ISO signals
# these per granule, the fixed choice costs a few bits of efficiency)
_REGION0_SFB = 8
_REGION1_SFB = 8


def _region_slices(big_lines: int) -> tuple[slice, slice, slice]:
    e0 = int(min(SFB_EDGES[_REGION0_SFB], big_lines))
    e1 = int(min(SFB_EDGES[_REGION0_SFB + _REGION1_SFB], big_lines))
    return slice(0, e0), slice(e0, e1), slice(e1, big_lines)


def _pair_region_bits(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(n_tables,) Huffman bits for one big-value region per table
    (+inf where a table cannot represent the region)."""
    tabs = _pair_tables()
    out = np.empty(len(tabs))
    sign = (x != 0).sum() + (y != 0).sum()
    for t, tab in enumerate(tabs):
        if tab.linbits == 0 and (x.size and max(x.max(initial=0),
                                                y.max(initial=0)) > tab.max):
            out[t] = np.inf
            continue
        xc = np.minimum(x, tab.max)
        yc = np.minimum(y, tab.max)
        esc = ((x >= tab.max).sum() + (y >= tab.max).sum()
               if tab.linbits else 0)
        # values above max+linbits range are unrepresentable
        if tab.linbits and x.size and max(x.max(initial=0),
                                          y.max(initial=0)) \
                > tab.max + (1 << tab.linbits) - 1:
            out[t] = np.inf
            continue
        out[t] = tab.len[xc, yc].sum() + esc * tab.linbits + sign
    return out


def _granule_bits(q: np.ndarray) -> float:
    """Total Huffman bits to code quantized lines ``q`` (best tables)."""
    big, n1 = _split_regions(q)
    bits = 0.0
    for sl in _region_slices(2 * big):
        x = q[sl][0::2]
        y = q[sl][1::2]
        if x.size == 0:
            continue
        b = _pair_region_bits(x, y)
        if not np.isfinite(b.min()):
            return np.inf
        bits += b.min()
    c1 = q[2 * big: 2 * big + 4 * n1].reshape(-1, 4)
    if c1.size:
        syms = (c1 != 0) @ np.array([8, 4, 2, 1])
        qt = _quad_tables()
        bits += min(float(t.len[syms].sum()) for t in qt) \
            + int((c1 != 0).sum())
    return bits


def _split_regions(q: np.ndarray) -> tuple[int, int]:
    """(big_value_pairs, count1_quads) for a 576-line granule."""
    nz = np.flatnonzero(q)
    if nz.size == 0:
        return 0, 0
    last = int(nz[-1]) + 1
    # count1 region: trailing run (below ``last`` rounded up to quads)
    # where every |value| <= 1
    gt1 = np.flatnonzero(q > 1)
    big_end = int(gt1[-1]) + 1 if gt1.size else 0
    big = (big_end + 1) // 2          # pairs
    c1_start = 2 * big
    n1 = max(0, (last - c1_start + 3) // 4)
    while c1_start + 4 * n1 > GRANULE:
        n1 -= 1
    return big, n1


# ===================== quantizer ===========================================

def _quantize(xr: np.ndarray, gg: int, sf: np.ndarray) -> np.ndarray:
    step = 2.0 ** (gg / 4.0 - np.repeat(sf, np.diff(SFB_EDGES)) / 2.0)
    u = (np.abs(xr) / step) ** 0.75 - 0.0946
    return np.maximum(np.round(u), 0.0).astype(np.int64)


def _dequantize(q: np.ndarray, sign: np.ndarray, gg: int,
                sf: np.ndarray) -> np.ndarray:
    step = 2.0 ** (gg / 4.0 - np.repeat(sf, np.diff(SFB_EDGES)) / 2.0)
    return sign * (q.astype(np.float64) ** (4.0 / 3.0)) * step


def _inner_loop(xr_abs_signless: np.ndarray, sf: np.ndarray,
                budget: float, gg_hint: int | None = None
                ) -> tuple[int, np.ndarray]:
    """Smallest global_gain whose Huffman-coded granule fits ``budget``."""
    lo, hi = -120, 380              # step 2^(gg/4): 2^-30 .. 2^95
    if gg_hint is not None:
        # exponential probe around the hint to tighten the bisection
        g = gg_hint
        if _granule_bits(_quantize(xr_abs_signless, g, sf)) <= budget:
            hi = g
        else:
            lo = g
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _granule_bits(_quantize(xr_abs_signless, mid, sf)) <= budget:
            hi = mid
        else:
            lo = mid
    return hi, _quantize(xr_abs_signless, hi, sf)


def _band_energies(v: np.ndarray) -> np.ndarray:
    return np.add.reduceat(v * v, SFB_EDGES[:-1])


def _outer_loop(xr: np.ndarray, xmin: np.ndarray, budget: float
                ) -> tuple[int, np.ndarray, np.ndarray]:
    """Rate/distortion iteration: returns (global_gain, sf, q)."""
    sign = np.sign(xr)
    ax = np.abs(xr)
    sf = np.zeros(N_SFB, dtype=np.int64)
    gg, q = _inner_loop(ax, sf, budget)
    best = (gg, sf.copy(), q)
    for _ in range(24):
        err = _band_energies(np.abs(_dequantize(q, sign, gg, sf)) - ax)
        over = (err > xmin) & (sf < _SF_MAX)
        if not over.any():
            break
        sf = sf + over
        gg, q = _inner_loop(ax, sf, budget, gg_hint=gg)
        best = (gg, sf.copy(), q)
    return best


# ===================== psychoacoustics =====================================

def _granule_xmin(frame: np.ndarray, xr: np.ndarray, fs: int) -> np.ndarray:
    """Allowed noise energy per scalefactor band (xr units).

    Same absolute-calibration sidestep as Layer II's SMR: the FFT
    analysis gives a signal-to-mask ratio per band; the allowance is
    the band's MDCT energy divided by it.
    """
    _, _, _, _, win, _ = _psy_consts(fs)
    seg = np.zeros(_FFT_N)
    n = min(frame.size, _FFT_N)
    seg[:n] = frame[:n]
    F = np.fft.rfft(seg * win)
    xdb = 96.0 + 20.0 * np.log10(2.0 * np.abs(F) / win.sum() + 1e-30)
    ltg = _global_threshold(xdb, fs)
    # map FFT bins to MDCT lines: line l center freq (l+.5)*fs/1152
    line_bins = np.minimum(
        ((np.arange(GRANULE) + 0.5) * _FFT_N / 1152.0).astype(int),
        xdb.size - 1)
    smr_line = xdb[line_bins] - ltg[line_bins]
    e_band = _band_energies(xr)
    smr_band = np.maximum.reduceat(smr_line, SFB_EDGES[:-1])
    return e_band / 10.0 ** (np.clip(smr_band, 0.0, 60.0) / 10.0)


# ===================== encoder =============================================

def encode(x: np.ndarray, fs: int = 48_000,
           bitrate_kbps: int = 128) -> bytes:
    """Mono float samples in [-1, 1] -> Layer III bitstream bytes."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    # MDCT adds 576 samples latency on top of the polyphase DELAY
    xp = np.concatenate([x, np.zeros(DELAY + GRANULE)])
    n_frames = -(-xp.size // FRAME_SAMPLES)
    xp = np.concatenate([xp, np.zeros(n_frames * FRAME_SAMPLES - xp.size)])

    s = analyze(xp)                                   # (36*n_frames, 32)
    X = _mdct_granules(s)                             # (2*n_frames, 576)
    X = _alias_reduce(X, inverse=True)

    frame_bits = FRAME_SAMPLES * bitrate_kbps * 1000 // fs
    g_mean = frame_bits // 2

    w = _BitWriter()
    w.write(_MAGIC3, 16)
    w.write(bitrate_kbps, 12)
    w.write(n_frames, 20)
    w.write(fs // 25, 12)

    tabs = _pair_tables()
    qts = _quad_tables()
    reservoir = 0
    for g in range(2 * n_frames):
        xr = X[g]
        frame = xp[GRANULE * g: GRANULE * g + FRAME_SAMPLES]
        xmin = _granule_xmin(frame, xr, fs)
        # side-info cost for this granule (fixed width here)
        side = _GG_BITS + 10 + 16 + 3 * 3 + 1 + 4 * N_SFB
        # reservoir borrow: up to half the accumulated surplus (the ISO
        # encoder suggestion); the surplus itself is capped at 511 bytes
        budget = g_mean - side + min(reservoir, _RESERVOIR_MAX) // 2
        gg, sf, q = _outer_loop(xr, xmin, float(max(budget, 32)))
        sign = np.sign(xr)

        big, n1 = _split_regions(q)
        # per-region table choice
        tsel = []
        for sl in _region_slices(2 * big):
            xs, ys = q[sl][0::2], q[sl][1::2]
            tsel.append(int(np.argmin(_pair_region_bits(xs, ys)))
                        if xs.size else 0)
        c1 = q[2 * big: 2 * big + 4 * n1].reshape(-1, 4)
        c1_sym = (c1 != 0) @ np.array([8, 4, 2, 1]) if c1.size else \
            np.empty(0, np.int64)
        qsel = int(np.argmin([t.len[c1_sym].sum() for t in qts])) \
            if c1.size else 0

        w.write(gg + 120, _GG_BITS)
        w.write(big, 10)
        # scalefactors: fixed 4 bits each (slen simplification)
        for b in range(N_SFB):
            w.write(int(sf[b]), 4)
        for t in tsel:
            w.write(t, 3)
        w.write(qsel, 1)
        w.write(n1, 16)
        # -- Huffman data ------------------------------------------------
        for sl, t in zip(_region_slices(2 * big), tsel):
            tab = tabs[t]
            xs, ys = q[sl][0::2], q[sl][1::2]
            ss_x = sign[sl][0::2]
            ss_y = sign[sl][1::2]
            for i in range(xs.size):
                xv, yv = int(xs[i]), int(ys[i])
                xc, yc = min(xv, tab.max), min(yv, tab.max)
                w.write(int(tab.code[xc, yc]), int(tab.len[xc, yc]))
                if tab.linbits and xc == tab.max:
                    w.write(xv - tab.max, tab.linbits)
                if xv:
                    w.write(0 if ss_x[i] > 0 else 1, 1)
                if tab.linbits and yc == tab.max:
                    w.write(yv - tab.max, tab.linbits)
                if yv:
                    w.write(0 if ss_y[i] > 0 else 1, 1)
        qt = qts[qsel]
        c1_sign = sign[2 * big: 2 * big + 4 * n1].reshape(-1, 4) \
            if c1.size else np.empty((0, 4))
        for i in range(c1.shape[0]):
            sym = int(c1_sym[i])
            w.write(int(qt.code[sym]), int(qt.len[sym]))
            for j in range(4):
                if c1[i, j]:
                    w.write(0 if c1_sign[i, j] > 0 else 1, 1)
        # -- bit-reservoir accounting (the real CBR mechanism) -----------
        # ``nominal`` bits have been granted by the constant rate after
        # granule g; the reservoir is the unspent surplus.  A granule
        # never spends more than granted + carried surplus (the inner
        # loop enforced its budget), and surplus beyond the 511-byte cap
        # is donated as padding -- exactly the ISO main_data reservoir
        # behavior, with the side info written inline instead of behind
        # a main_data_begin back-pointer.
        nominal = ((g + 1) * frame_bits) // 2
        written = w.bits_written() - 60
        if written < nominal - _RESERVOIR_MAX:
            pad = (nominal - _RESERVOIR_MAX) - written
            while pad > 0:
                c = min(pad, 32)
                w.write(0, c)
                pad -= c
            written = nominal - _RESERVOIR_MAX
        reservoir = nominal - written
    # CBR tail: stream length = header + n_frames*frame_bits exactly
    total = 60 + n_frames * frame_bits
    tail = total - w.bits_written()
    assert tail >= 0, "stream overran the constant bitrate"
    while tail > 0:
        c = min(tail, 32)
        w.write(0, c)
        tail -= c
    return w.getvalue()


# ===================== decoder =============================================

def decode(blob: bytes) -> tuple[np.ndarray, int]:
    """Layer III bitstream bytes -> (mono float samples, fs)."""
    r = _BitReader(blob)
    if r.read(16) != _MAGIC3:
        raise ValueError("not an echoseal mpeg1-l3 stream")
    bitrate_kbps = r.read(12)
    n_frames = r.read(20)
    fs = r.read(12) * 25

    tabs = _pair_tables()
    qts = _quad_tables()
    X = np.zeros((2 * n_frames, GRANULE))
    for g in range(2 * n_frames):
        gg = r.read(_GG_BITS) - 120
        big = r.read(10)
        sf = np.array([r.read(4) for _ in range(N_SFB)], dtype=np.int64)
        tsel = [r.read(3) for _ in range(3)]
        qsel = r.read(1)
        n1 = r.read(16)
        q = np.zeros(GRANULE, dtype=np.int64)
        sign = np.ones(GRANULE)
        for sl, t in zip(_region_slices(2 * big), tsel):
            tab = tabs[t]
            pos = sl.start
            while pos < sl.stop:
                xv, yv = _read_pair(r, tab)
                q[pos], q[pos + 1] = xv[0], yv[0]
                sign[pos], sign[pos + 1] = xv[1], yv[1]
                pos += 2
        qt = qts[qsel]
        pos = 2 * big
        for _ in range(n1):
            sym = _read_tree(r, qt.tree)
            for j, bit in enumerate((sym >> 3 & 1, sym >> 2 & 1,
                                     sym >> 1 & 1, sym & 1)):
                if bit:
                    q[pos + j] = 1
                    sign[pos + j] = -1.0 if r.read(1) else 1.0
            pos += 4
        X[g] = _dequantize(q, sign, gg, sf)
    X = _alias_reduce(X, inverse=False)
    s = _imdct_granules(X)
    return synthesize(s), fs


def _read_tree(r: _BitReader, tree: dict) -> int:
    ln, code = 0, 0
    while True:
        code = (code << 1) | r.read(1)
        ln += 1
        hit = tree.get((ln, code))
        if hit is not None:
            return hit
        if ln > 32:
            raise ValueError("bad huffman stream")


def _read_pair(r: _BitReader, tab: _PairTable):
    x, y = _read_tree(r, tab.tree)
    if tab.linbits and x == tab.max:
        x += r.read(tab.linbits)
    sx = (-1.0 if r.read(1) else 1.0) if x else 1.0
    if tab.linbits and y == tab.max:
        y += r.read(tab.linbits)
    sy = (-1.0 if r.read(1) else 1.0) if y else 1.0
    return (x, sx), (y, sy)


def roundtrip(x: np.ndarray, fs: int = 48_000,
              bitrate_kbps: int = 128) -> np.ndarray:
    """Encode -> decode, delay-compensated to the input length."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    y, _ = decode(encode(x, fs, bitrate_kbps))
    d = DELAY + GRANULE
    out = y[d: d + x.size]
    if out.size < x.size:
        out = np.concatenate([out, np.zeros(x.size - out.size)])
    return out.astype(np.float32)
