"""MPEG-1 Audio Layer II codec (ISO/IEC 11172-3 algorithm), pure NumPy.

The port's copy of ``echoseal_tpu/utils/mpeg1.py``: a host module whose
bitstreams are byte-identical to the JAX package's.  A real perceptual
transform codec, the Layer II algorithm end to end --

* 32-band polyphase analysis/synthesis with the ISO filterbank
  equations (C.1.3 analysis matrixing, 2.4.3.2.2 V/U synthesis) and a
  512-tap window pair optimised for that exact structure
  (data/pqmf512.py; 64 dB reconstruction SNR, delay 481 samples),
* scalefactors from the ISO Table B.1 ladder (2 * 2^(-i/3)) with real
  scfsi transmission patterns,
* a psychoacoustic model in the ISO model-1 family: 1024-point FFT,
  tonal/non-tonal masker extraction, Terhardt absolute threshold,
  two-slope spreading, per-subband signal-to-mask ratios,
* greedy minimum-MNR bit allocation against ISO Table B.2a quantizer
  classes (sblimit 27) and the Table C SNR ladder, under the true
  frame bit budget (1152 samples * bitrate / fs, header + allocation
  + scfsi + scalefactor + sample bits all counted),
* grouped (3/5/9-level) and ungrouped midtread quantization, and a
  REAL serialized bitstream: ``encode`` emits bytes, ``decode`` parses
  them back -- nothing can leak around the bit budget.

Deviations from a conformance-grade implementation, stated so nobody
mistakes the claim: the 512-tap window is designed (the ISO Table C/D
coefficients are not reproducible in-image), the 32-bit frame header
carries a private magic instead of the ISO syncword fields, and the
psychoacoustic model uses the published Terhardt quiet-threshold
approximation instead of the ISO D.1 tables.  Streams therefore do not
interoperate with consumer decoders, but the rate/distortion path --
subband quantization noise shaped by masking, band truncation under
the bit budget, constant bitrate -- is the real Layer II algorithm,
not a spectral simulation.
"""
from __future__ import annotations

import functools

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from echoseal_torch.data.pqmf512 import DELAY, window_pair

FRAME_SAMPLES = 1152
SUBBANDS = 32
SBLIMIT = 27          # ISO Table B.2a (48 kHz, >=96 kbps mono)
_MAGIC = 0x3AD2

# ---- ISO Table B.1 scalefactors: 2 * 2^(-i/3), i = 0..62 ----------------
SCF_TABLE = 2.0 * 2.0 ** (-np.arange(63) / 3.0)

# ---- ISO Table B.2a quantizer classes per subband ------------------------
_STEPS_A = (3, 7, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191,
            16383, 32767, 65535)
_STEPS_B = (3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095,
            8191, 65535)
_STEPS_C = (3, 5, 7, 9, 15, 31, 65535)
_STEPS_D = (3, 5, 65535)
ALLOC_STEPS: tuple[tuple[int, ...], ...] = (
    (_STEPS_A,) * 3 + (_STEPS_B,) * 8 + (_STEPS_C,) * 12 + (_STEPS_D,) * 4)
NBAL = (4,) * 3 + (4,) * 8 + (3,) * 12 + (2,) * 4

# ---- ISO Table C SNR of each quantizer class (dB) -------------------------
SNR_DB = {3: 7.00, 5: 11.00, 7: 16.00, 9: 20.84, 15: 25.28, 31: 31.59,
          63: 37.75, 127: 43.84, 255: 49.89, 511: 55.93, 1023: 61.96,
          2047: 67.98, 4095: 74.01, 8191: 80.03, 16383: 86.05,
          32767: 92.01, 65535: 98.01}

_GROUP_BITS = {3: 5, 5: 7, 9: 10}     # one codeword per 3 samples


def _code_bits(steps: int) -> tuple[int, bool]:
    """(bits per 3-sample triplet, grouped?)."""
    if steps in _GROUP_BITS:
        return _GROUP_BITS[steps], True
    return 3 * int(steps + 1).bit_length() - 3, False


# ===================== polyphase filterbank ===============================

@functools.lru_cache(maxsize=1)
def _filterbank():
    C, D = window_pair()
    n = np.arange(64)
    k = np.arange(32)
    M = np.cos((2 * k[:, None] + 1) * (n[None, :] - 16) * np.pi / 64)
    N = np.cos((16 + n[:, None]) * (2 * k[None, :] + 1) * np.pi / 64)
    return C, D, M, N


def analyze(x: np.ndarray) -> np.ndarray:
    """(T,) samples -> (ceil(T/32), 32) subband samples (ISO C.1.3)."""
    C, _, M, _ = _filterbank()
    T = -(-x.size // 32) * 32
    xp = np.concatenate([np.zeros(511), x.astype(np.float64),
                         np.zeros(T - x.size)])
    W = sliding_window_view(xp, 512)[31::32]       # rows end at sample 32t+31
    zX = (W * C[::-1][None, :])[:, ::-1]           # back to ISO X-index order
    y = zX.reshape(-1, 8, 64).sum(axis=1)
    return y @ M.T


def synthesize(s: np.ndarray) -> np.ndarray:
    """(T, 32) subband samples -> (T*32,) samples (ISO 2.4.3.2.2)."""
    _, D, _, N = _filterbank()
    T = s.shape[0]
    V = s @ N.T                                    # (T, 64)
    Vp = np.concatenate([np.zeros((16, 64)), V])
    out = np.zeros((T, 32))
    for i in range(8):
        out += Vp[16 - 2 * i: 16 - 2 * i + T, :32] \
            * D[64 * i: 64 * i + 32][None, :]
        out += Vp[15 - 2 * i: 15 - 2 * i + T, 32:] \
            * D[64 * i + 32: 64 * i + 64][None, :]
    return out.reshape(-1)


# ===================== psychoacoustic model ================================

_FFT_N = 1024


def _bark(f_hz: np.ndarray) -> np.ndarray:
    return (13.0 * np.arctan(0.00076 * f_hz)
            + 3.5 * np.arctan((f_hz / 7500.0) ** 2))


def _quiet_threshold_db(f_hz: np.ndarray) -> np.ndarray:
    """Terhardt threshold-in-quiet approximation (dB SPL)."""
    f = np.maximum(f_hz, 20.0) / 1000.0
    return (3.64 * f ** -0.8 - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
            + 1e-3 * f ** 4)


# critical band edges (Hz), Zwicker
_CB_EDGES = np.array([0, 100, 200, 300, 400, 510, 630, 770, 920, 1080,
                      1270, 1480, 1720, 2000, 2320, 2700, 3150, 3700,
                      4400, 5300, 6400, 7700, 9500, 12000, 15500, 24000.0])


@functools.lru_cache(maxsize=8)
def _psy_consts(fs: int):
    freqs = np.arange(_FFT_N // 2 + 1) * fs / _FFT_N
    zb = _bark(freqs)
    tq = _quiet_threshold_db(freqs)
    cb = np.searchsorted(_CB_EDGES, freqs, side="right") - 1
    win = np.hanning(_FFT_N)
    # neighbourhood width for the tonality test, per ISO model 1 ranges
    dk = np.full(freqs.size, 2)
    dk[freqs >= fs / 16] = 3
    dk[freqs >= fs / 8] = 6
    dk[freqs >= fs / 4] = 12
    return freqs, zb, tq, cb, win, dk


def _global_threshold(xdb: np.ndarray, fs: int) -> np.ndarray:
    """Per-bin global masking threshold (dB) from one spectrum."""
    freqs, zb, tq, cb, _, dk = _psy_consts(fs)
    n = xdb.size
    p = 10.0 ** (xdb / 10.0)

    # tonal maskers: local maxima >= 7 dB over their neighbourhood
    tonal_idx: list[int] = []
    cand = np.flatnonzero((xdb[1:-1] > xdb[:-2]) & (xdb[1:-1] >= xdb[2:])) + 1
    for k in cand:
        if k < 3 or k > n - 13:
            continue
        w = int(dk[k])
        lo, hi = max(0, k - w), min(n, k + w + 1)
        neigh = np.r_[xdb[lo: k - 1], xdb[k + 2: hi]]
        if neigh.size and xdb[k] >= neigh.max() + 7.0:
            tonal_idx.append(int(k))
    tonal_idx = np.asarray(tonal_idx, dtype=int)
    p_res = p.copy()
    x_tm = np.empty(0)
    if tonal_idx.size:
        x_tm = 10.0 * np.log10(p[tonal_idx - 1] + p[tonal_idx]
                               + p[tonal_idx + 1] + 1e-30)
        for k in tonal_idx:
            p_res[max(0, k - 1): k + 2] = 0.0

    # non-tonal maskers: residual power per critical band at its
    # power-weighted centre bin
    nt_idx: list[int] = []
    x_nm: list[float] = []
    for b in range(_CB_EDGES.size - 1):
        sel = cb == b
        pw = float(p_res[sel].sum())
        if pw <= 1e-20:
            continue
        kctr = int(np.round(np.flatnonzero(sel)
                            @ p_res[sel] / pw))
        nt_idx.append(min(kctr, n - 1))
        x_nm.append(10.0 * np.log10(pw + 1e-30))
    nt_idx = np.asarray(nt_idx, dtype=int)
    x_nm = np.asarray(x_nm)

    # decimation: drop maskers under the quiet threshold; merge tonal
    # pairs closer than 0.5 bark (keep the stronger)
    if tonal_idx.size:
        keep = x_tm >= tq[tonal_idx]
        tonal_idx, x_tm = tonal_idx[keep], x_tm[keep]
        order = np.argsort(zb[tonal_idx])
        tonal_idx, x_tm = tonal_idx[order], x_tm[order]
        keep_mask = np.ones(tonal_idx.size, bool)
        for i in range(1, tonal_idx.size):
            if zb[tonal_idx[i]] - zb[tonal_idx[i - 1]] < 0.5:
                if x_tm[i] >= x_tm[i - 1]:
                    keep_mask[i - 1] = False
                else:
                    keep_mask[i] = False
        tonal_idx, x_tm = tonal_idx[keep_mask], x_tm[keep_mask]
    if nt_idx.size:
        keep = x_nm >= tq[nt_idx]
        nt_idx, x_nm = nt_idx[keep], x_nm[keep]

    # individual thresholds via the ISO two-slope spreading function
    thr_p = 10.0 ** (tq / 10.0)

    def spread(idx: np.ndarray, xm: np.ndarray, av_a: float, av_b: float):
        if idx.size == 0:
            return 0.0
        zm = zb[idx][:, None]
        dz = zb[None, :] - zm
        xmc = xm[:, None]
        vf = np.where(
            dz < -1.0, 17.0 * (dz + 1.0) - (0.4 * xmc + 6.0),
            np.where(dz < 0.0, (0.4 * xmc + 6.0) * dz,
                     np.where(dz < 1.0, -17.0 * dz,
                              -(dz - 1.0) * (17.0 - 0.15 * xmc) - 17.0)))
        lt = xmc + (av_a * zm + av_b) + vf
        lt = np.where((dz >= -3.0) & (dz < 8.0), lt, -1e30)
        return (10.0 ** (lt / 10.0)).sum(axis=0)

    thr_p = thr_p + spread(tonal_idx, x_tm, -0.275, -1.525 - 4.5)
    thr_p = thr_p + spread(nt_idx, x_nm, -0.175, -1.525 - 0.5)
    return 10.0 * np.log10(thr_p + 1e-30)


def _frame_smr(frame: np.ndarray, scf_max: np.ndarray, fs: int) -> np.ndarray:
    """(1152,) samples + (SBLIMIT,) max scalefactor -> SMR (SBLIMIT,) dB."""
    _, _, _, _, win, _ = _psy_consts(fs)
    bins_per_sb = _FFT_N // (2 * SUBBANDS)         # 16
    smr = np.full(SBLIMIT, -1e30)
    for off in (0, FRAME_SAMPLES - _FFT_N):
        seg = frame[off: off + _FFT_N]
        F = np.fft.rfft(seg * win)
        # full-scale sine -> 96 dB
        xdb = 96.0 + 20.0 * np.log10(2.0 * np.abs(F) / win.sum() + 1e-30)
        ltg = _global_threshold(xdb, fs)
        for sb in range(SBLIMIT):
            sl = slice(sb * bins_per_sb, (sb + 1) * bins_per_sb + 1)
            l_sb = max(float(xdb[sl].max()),
                       20.0 * np.log10(scf_max[sb] * 32768.0 + 1e-30) - 10.0)
            smr[sb] = max(smr[sb], l_sb - float(ltg[sl].min()))
    return smr


# ===================== bit allocation ======================================

def _allocate(smr: np.ndarray, scf_cost: np.ndarray, budget: int
              ) -> np.ndarray:
    """Greedy minimum-MNR allocation (ISO C.1.5.3.1). Returns class idx+0."""
    alloc = np.zeros(SBLIMIT, dtype=int)      # 0 = no bits
    used = 0
    snr = np.zeros(SBLIMIT)
    while True:
        best_sb, best_mnr, best_cost = -1, None, 0
        for sb in range(SBLIMIT):
            steps = ALLOC_STEPS[sb]
            if alloc[sb] >= len(steps):
                continue
            bits_new, _ = _code_bits(steps[alloc[sb]])
            bits_old = (_code_bits(steps[alloc[sb] - 1])[0]
                        if alloc[sb] > 0 else 0)
            cost = 12 * (bits_new - bits_old)
            if alloc[sb] == 0:
                cost += int(scf_cost[sb])
            if used + cost > budget:
                continue
            mnr = snr[sb] - smr[sb]
            if best_mnr is None or mnr < best_mnr:
                best_sb, best_mnr, best_cost = sb, mnr, cost
        if best_sb < 0:
            break
        alloc[best_sb] += 1
        used += best_cost
        snr[best_sb] = SNR_DB[ALLOC_STEPS[best_sb][alloc[best_sb] - 1]]
    return alloc


# ===================== bitstream ===========================================

class _BitWriter:
    def __init__(self) -> None:
        self._out = bytearray()
        self._acc = 0
        self._n = 0

    def write(self, value: int, bits: int) -> None:
        self._acc = (self._acc << bits) | (value & ((1 << bits) - 1))
        self._n += bits
        while self._n >= 8:
            self._n -= 8
            self._out.append((self._acc >> self._n) & 0xFF)
        self._acc &= (1 << self._n) - 1

    def bits_written(self) -> int:
        return 8 * len(self._out) + self._n

    def getvalue(self) -> bytes:
        if self._n:
            self._out.append((self._acc << (8 - self._n)) & 0xFF)
            self._acc = self._n = 0
        return bytes(self._out)


class _BitReader:
    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0

    def read(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def align_frame(self, frame_bits: int, frame_start: int) -> None:
        self._pos = frame_start + frame_bits


# ===================== encoder / decoder ===================================

def _scfsi_pick(idx3: np.ndarray) -> tuple[int, list[int]]:
    """Lossless scfsi selection (ISO transmission patterns 0-3)."""
    a, b, c = int(idx3[0]), int(idx3[1]), int(idx3[2])
    if a == b == c:
        return 2, [a]
    if a == b:
        return 1, [a, c]
    if b == c:
        return 3, [a, b]
    return 0, [a, b, c]


_SCFSI_EXPAND = {0: (0, 1, 2), 1: (0, 0, 1), 2: (0, 0, 0), 3: (0, 1, 1)}


def encode(x: np.ndarray, fs: int = 48_000,
           bitrate_kbps: int = 128) -> bytes:
    """Mono float samples in [-1, 1] -> Layer II bitstream bytes."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    # pad so the decoder's delay-compensated output covers every sample
    xp = np.concatenate([x, np.zeros(DELAY)])
    n_frames = -(-xp.size // FRAME_SAMPLES)
    xp = np.concatenate([xp, np.zeros(n_frames * FRAME_SAMPLES - xp.size)])

    s_all = analyze(xp)                           # (n_frames*36, 32)
    frame_bits = FRAME_SAMPLES * bitrate_kbps * 1000 // fs
    static_bits = 32 + sum(NBAL)                  # header + allocation field

    w = _BitWriter()
    w.write(_MAGIC, 16)
    w.write(bitrate_kbps, 12)
    w.write(n_frames, 20)
    w.write(fs // 25, 12)                          # fs up to 102.4 kHz
    # stream header is 60 bits (once); per-frame headers are the 32-bit
    # budget entry below

    for fi in range(n_frames):
        frame_start = w.bits_written()
        s = s_all[36 * fi: 36 * (fi + 1), :SBLIMIT]    # (36, SBLIMIT)

        # scalefactors per 12-sample part
        parts = np.abs(s).reshape(3, 12, SBLIMIT).max(axis=1)  # (3, SBLIMIT)
        scf_idx = np.searchsorted(-SCF_TABLE, -np.minimum(parts, 1.9999))
        scf_idx = np.minimum(scf_idx, 62)
        # SCF_TABLE is descending; searchsorted on the negated table
        # returns the FIRST index whose value <= parts; ISO wants the
        # smallest scalefactor >= the part maximum, i.e. one step back
        # when the table value is strictly below the part max
        below = SCF_TABLE[scf_idx] < parts
        scf_idx = np.maximum(scf_idx - below.astype(int), 0)

        scfsi = np.empty(SBLIMIT, dtype=int)
        scf_tx: list[list[int]] = []
        scf_cost = np.empty(SBLIMIT, dtype=int)
        for sb in range(SBLIMIT):
            si, tx = _scfsi_pick(scf_idx[:, sb])
            scfsi[sb] = si
            scf_tx.append(tx)
            scf_cost[sb] = 2 + 6 * len(tx)

        frame = xp[FRAME_SAMPLES * fi: FRAME_SAMPLES * (fi + 1)]
        smr = _frame_smr(frame, SCF_TABLE[scf_idx.min(axis=0)], fs)
        alloc = _allocate(smr, scf_cost, frame_bits - static_bits)

        w.write(0xFFF, 12)                         # frame sync
        w.write(fi & 0xFFFFF, 20)                  # 32-bit frame header
        for sb in range(SBLIMIT):
            w.write(int(alloc[sb]), NBAL[sb])
        for sb in range(SBLIMIT):
            if alloc[sb]:
                w.write(int(scfsi[sb]), 2)
        for sb in range(SBLIMIT):
            if alloc[sb]:
                for v in scf_tx[sb]:
                    w.write(int(v), 6)
        # samples: 12 triplets x active subbands
        for t in range(12):
            part = t // 4
            for sb in range(SBLIMIT):
                if not alloc[sb]:
                    continue
                steps = ALLOC_STEPS[sb][alloc[sb] - 1]
                sf = SCF_TABLE[scf_idx[part, sb]]
                xs = np.clip(s[3 * t: 3 * t + 3, sb] / sf, -1.0, 1.0)
                q = np.clip(np.round((xs + 1.0) * 0.5 * (steps - 1)),
                            0, steps - 1).astype(int)
                bits, grouped = _code_bits(steps)
                if grouped:
                    w.write(int(q[0] + steps * q[1] + steps * steps * q[2]),
                            bits)
                else:
                    per = bits // 3
                    for v in q:
                        w.write(int(v), per)
        pad = frame_bits - (w.bits_written() - frame_start)
        assert pad >= 0, "frame overran its bit budget"
        while pad > 0:
            chunk = min(pad, 32)
            w.write(0, chunk)
            pad -= chunk
    return w.getvalue()


def decode(blob: bytes) -> tuple[np.ndarray, int]:
    """Layer II bitstream bytes -> (mono float samples, fs).

    The returned signal includes the filterbank delay; use
    :func:`roundtrip` for delay-compensated same-length processing.
    """
    r = _BitReader(blob)
    if r.read(16) != _MAGIC:
        raise ValueError("not an echoseal mpeg1 stream")
    bitrate_kbps = r.read(12)
    n_frames = r.read(20)
    fs = r.read(12) * 25
    frame_bits = FRAME_SAMPLES * bitrate_kbps * 1000 // fs

    s_all = np.zeros((n_frames * 36, SUBBANDS))
    for fi in range(n_frames):
        frame_start = r._pos
        if r.read(12) != 0xFFF:
            raise ValueError(f"lost frame sync at frame {fi}")
        r.read(20)
        alloc = [r.read(NBAL[sb]) for sb in range(SBLIMIT)]
        scfsi = [r.read(2) if alloc[sb] else 0 for sb in range(SBLIMIT)]
        scf = np.zeros((3, SBLIMIT), dtype=int)
        for sb in range(SBLIMIT):
            if alloc[sb]:
                tx = [r.read(6)
                      for _ in range(len(set(_SCFSI_EXPAND[scfsi[sb]])))]
                for part in range(3):
                    scf[part, sb] = tx[_SCFSI_EXPAND[scfsi[sb]][part]]
        s = np.zeros((36, SBLIMIT))
        for t in range(12):
            part = t // 4
            for sb in range(SBLIMIT):
                if not alloc[sb]:
                    continue
                steps = ALLOC_STEPS[sb][alloc[sb] - 1]
                bits, grouped = _code_bits(steps)
                if grouped:
                    c = r.read(bits)
                    q = np.array([c % steps, (c // steps) % steps,
                                  c // (steps * steps)])
                else:
                    per = bits // 3
                    q = np.array([r.read(per) for _ in range(3)])
                xs = 2.0 * q / (steps - 1) - 1.0
                s[3 * t: 3 * t + 3, sb] = xs * SCF_TABLE[scf[part, sb]]
        s_all[36 * fi: 36 * (fi + 1), :SBLIMIT] = s
        r.align_frame(frame_bits, frame_start)
    return synthesize(s_all), fs


def roundtrip(x: np.ndarray, fs: int = 48_000,
              bitrate_kbps: int = 128) -> np.ndarray:
    """Encode -> decode, delay-compensated to the input length."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    y, _ = decode(encode(x, fs, bitrate_kbps))
    out = y[DELAY: DELAY + x.size]
    if out.size < x.size:
        out = np.concatenate([out, np.zeros(x.size - out.size)])
    return out.astype(np.float32)
