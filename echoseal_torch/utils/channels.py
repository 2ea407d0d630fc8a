"""Channel impairments: the fault-injection library for tests and the chip smoke.

The port's copy of ``echoseal_tpu/utils/channels.py``.  Every function
is a host numpy transform, as in the JAX package: they model the world
outside the device, not device compute.  On the same input and the same
seeded ``rng`` each output is bit-identical to the JAX function's.

* ``awgn``        -- additive white noise at a target SNR
* ``lowpass``     -- LPF below the hop bands (strips the watermark)
* ``clip``        -- hard amplitude clipping
* ``time_scale``  -- +-x% playback-speed change (polyphase resample)
* ``codec_sim``   -- MP3-128k-like simulation: 16 kHz bandwidth cut +
  windowed-DFT quantisation noise at a bits/coefficient budget
* ``codec_ulaw`` / ``codec_alaw`` / ``codec_adpcm`` -- real lossy codecs
  (G.711 mu-law / A-law 8-bit companding, IMA ADPCM 4-bit differential)
  through the stdlib ``audioop`` encoder/decoder pair
* ``codec_mpeg1_l2`` -- real MPEG-1 Audio Layer II round trip through
  the in-repo codec (utils/mpeg1.py)
* ``codec_mpeg1_l3`` -- real MPEG-1 Audio Layer III (the MP3 algorithm)
  round trip through the in-repo codec (utils/mpeg1_l3.py)
* ``codec_ratecv`` -- real sample-rate conversion through
  ``audioop.ratecv`` (a linear-interpolation converter, not this repo's
  polyphase resampler): a capture clock other than the playback's
* ``excerpt``     -- random sub-clip (mid-stream capture)
* ``dropout``     -- zeroed sample bursts (packet loss)
* ``reverb``      -- synthetic room impulse response (direct path +
  sparse early reflections + exponentially decaying diffuse tail): the
  loudspeaker -> room -> microphone path of an acoustic capture
* ``speech_host`` -- a reproducible wideband speech surrogate host
"""
from __future__ import annotations

import numpy as np
from scipy.signal import butter, lfilter, resample_poly


def awgn(x: np.ndarray, snr_db: float, rng=None) -> np.ndarray:
    """Additive white Gaussian noise at ``snr_db`` relative to signal power."""
    rng = rng or np.random.default_rng(0)
    p_sig = float(np.mean(x * x)) + 1e-30
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    return (x + rng.standard_normal(x.size) * np.sqrt(p_noise)).astype(
        np.float32)


def lowpass(x: np.ndarray, cutoff_hz: float, fs: int = 48_000,
            order: int = 8) -> np.ndarray:
    b, a = butter(order, cutoff_hz / (fs / 2), "low")
    return lfilter(b, a, x).astype(np.float32)


def clip(x: np.ndarray, level: float = 0.5) -> np.ndarray:
    return np.clip(x, -level, level).astype(np.float32)


def time_scale(x: np.ndarray, factor: float, fs: int = 48_000) -> np.ndarray:
    """Playback-speed change by ``factor`` (1.05 = 5% fast)."""
    up, down = 1000, int(round(1000 * factor))
    return resample_poly(x, up, down).astype(np.float32)


def codec_sim(x: np.ndarray, bitrate_kbps: float = 128.0,
              fs: int = 48_000) -> np.ndarray:
    """MP3-like lossy codec simulation.

    Models the two artefacts that matter to an ultrasonic watermark:
    (1) the encoder's lowpass (~16 kHz at 128 kbps -- kills the 16-18 and
    18-22 kHz hop bands), and (2) spectral quantisation noise scaled to the
    bit budget, applied in 50%-overlap windowed-DFT (MDCT-like) frames.
    """
    n = 1152  # MP3 granule-pair size
    hop = n // 2
    win = np.sin(np.pi * (np.arange(n) + 0.5) / n).astype(np.float64)
    pad = (-(x.size - n) % hop)
    # a lead and a tail hop of zeros: every real output sample then has
    # full two-window overlap, so the 1/norm division below is ~1 where it
    # matters (a single window tail there, norm ~1e-6 at sample 0, would
    # amplify the quantisation noise into an onset transient far above
    # full scale)
    xp = np.concatenate([np.zeros(hop), x.astype(np.float64),
                         np.zeros(pad + n)])
    out = np.zeros_like(xp)
    norm = np.zeros_like(xp)
    # bits per coefficient from the rate budget
    coeffs_per_s = fs  # ~one coeff per sample across overlapped frames
    bits_per_coeff = max(bitrate_kbps * 1000.0 / coeffs_per_s, 0.5)
    q_snr = 10.0 ** (-(6.02 * bits_per_coeff) / 20.0)  # quantiser noise amp
    cutoff_bin = int(16_000 / fs * n)
    rng = np.random.default_rng(1234)
    for i in range(0, xp.size - n + 1, hop):
        seg = xp[i : i + n] * win
        spec = np.fft.rfft(seg)
        mag = np.abs(spec)
        spec = spec + (rng.standard_normal(spec.size)
                       + 1j * rng.standard_normal(spec.size)) * mag * q_snr
        spec[cutoff_bin:] = 0.0
        out[i : i + n] += np.fft.irfft(spec, n) * win
        norm[i : i + n] += win * win
    out = out / np.maximum(norm, 1e-9)
    return out[hop : hop + x.size].astype(np.float32)


def _audioop():
    """Import stdlib ``audioop`` with its 3.12 deprecation warning hushed.

    audioop is deprecated for removal in 3.13; a Python without it raises
    ImportError here.
    """
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import audioop
    return audioop


def _to_pcm16(x: np.ndarray) -> bytes:
    return np.clip(np.asarray(x, np.float64) * 32767.0,
                   -32768, 32767).astype("<i2").tobytes()


def _from_pcm16(b: bytes) -> np.ndarray:
    return (np.frombuffer(b, dtype="<i2").astype(np.float32) / 32767.0)


def codec_ulaw(x: np.ndarray) -> np.ndarray:
    """G.711 mu-law round trip: 16-bit PCM -> 8-bit mu-law -> PCM.

    Logarithmic companding quantisation (~38 dB SNR, signal-dependent)
    over the full band, by the stdlib's G.711 implementation.
    """
    ao = _audioop()
    return _from_pcm16(ao.ulaw2lin(ao.lin2ulaw(_to_pcm16(x), 2), 2))


def codec_alaw(x: np.ndarray) -> np.ndarray:
    """G.711 A-law round trip (the E1/European trunk variant)."""
    ao = _audioop()
    return _from_pcm16(ao.alaw2lin(ao.lin2alaw(_to_pcm16(x), 2), 2))


def codec_adpcm(x: np.ndarray) -> np.ndarray:
    """IMA/Intel ADPCM round trip: 4 bits/sample differential coding.

    An adaptive step-size delta coder whose prediction error grows with
    the signal's slope, so the 16-22 kHz hop bands take the most
    quantisation noise.
    """
    ao = _audioop()
    frag, _state = ao.lin2adpcm(_to_pcm16(x), 2, None)
    return _from_pcm16(ao.adpcm2lin(frag, 2, None)[0])


def codec_mpeg1_l2(x: np.ndarray, bitrate_kbps: int = 128,
                   fs: int = 48_000) -> np.ndarray:
    """MPEG-1 Audio Layer II encode -> decode at ``bitrate_kbps``.

    The in-repo codec (utils/mpeg1.py): 32-band polyphase filterbank,
    psychoacoustic bit allocation and a serialized bitstream.  The output
    is delay-compensated to the input length.
    """
    from echoseal_torch.utils.mpeg1 import roundtrip

    return roundtrip(np.asarray(x, dtype=np.float32), fs, bitrate_kbps)


def codec_mpeg1_l3(x: np.ndarray, bitrate_kbps: int = 128,
                   fs: int = 48_000) -> np.ndarray:
    """MPEG-1 Audio Layer III (the MP3 algorithm) encode -> decode.

    The in-repo codec (utils/mpeg1_l3.py): subband MDCT with alias
    reduction, power-law quantization in nested rate/distortion loops,
    Huffman-coded spectrum and a bit reservoir under a constant
    ``bitrate_kbps``.  The output is delay-compensated to the input
    length.
    """
    from echoseal_torch.utils.mpeg1_l3 import roundtrip

    return roundtrip(np.asarray(x, dtype=np.float32), fs, bitrate_kbps)


def codec_ratecv(x: np.ndarray, fs_in: int, fs_out: int) -> np.ndarray:
    """Rate conversion through ``audioop.ratecv`` (linear interpolation).

    Models a capture clock other than the playback's (a 48 kHz playback
    recorded by a 44.1 kHz device).  The returned clip is AT ``fs_out``
    and is verified with ``fs_in=fs_out``.
    """
    ao = _audioop()
    out, _state = ao.ratecv(_to_pcm16(x), 2, 1, fs_in, fs_out, None)
    return _from_pcm16(out)


def excerpt(x: np.ndarray, seconds: float, fs: int = 48_000,
            rng=None) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    n = int(seconds * fs)
    if x.size <= n:
        return x.astype(np.float32)
    start = int(rng.integers(0, x.size - n))
    return x[start : start + n].astype(np.float32)


def dropout(x: np.ndarray, burst_ms: float = 20.0, rate_hz: float = 1.0,
            fs: int = 48_000, rng=None) -> np.ndarray:
    """Zero out random bursts (packet loss / glitches)."""
    rng = rng or np.random.default_rng(0)
    y = x.astype(np.float32).copy()
    n_burst = int(burst_ms * fs / 1000.0)
    n_events = max(int(x.size / fs * rate_hz), 0)
    for _ in range(n_events):
        s = int(rng.integers(0, max(x.size - n_burst, 1)))
        y[s : s + n_burst] = 0.0
    return y


def room_impulse_response(rt60_ms: float = 150.0, *,
                          direct_to_reverb_db: float = 6.0,
                          n_early: int = 4, fs: int = 48_000,
                          rng=None) -> np.ndarray:
    """Synthetic room impulse response (acoustic capture model).

    Unit direct path at t=0; ``n_early`` sparse early reflections in the
    first ~15 ms at physical amplitudes (first bounce drawn at -6..-10 dB
    re direct, later ones decaying -- they carry the comb filtering that
    makes acoustic capture hard, so the energy normalisation must not
    wash them out); an exponentially decaying Gaussian diffuse tail
    (-60 dB at ``rt60_ms``) sized so the total reverberant energy
    (reflections + tail) sits ``direct_to_reverb_db`` below the direct
    path.  When the drawn reflections alone exceed that budget (a high
    ``direct_to_reverb_db``, a weak room), everything non-direct is
    scaled down to fit: the budget is the contract.
    """
    rng = rng or np.random.default_rng(0)
    n = max(int(rt60_ms * fs / 1000.0), 64)
    t = np.arange(n)
    e_budget = 10.0 ** (-direct_to_reverb_db / 10.0)

    refl = np.zeros(n)
    amp = float(rng.uniform(0.32, 0.5))          # first bounce -6..-10 dB
    for _ in range(n_early):
        d = int(rng.integers(int(0.001 * fs), int(0.015 * fs)))
        if d < n:
            refl[d] += float(rng.choice([-1.0, 1.0])) * amp
        amp *= float(rng.uniform(0.5, 0.8))
    e_refl = float(np.sum(refl * refl))
    if e_refl > 0.75 * e_budget:
        refl *= np.sqrt(0.75 * e_budget / e_refl)
        e_refl = 0.75 * e_budget

    tau = (rt60_ms * fs / 1000.0) / np.log(1000.0)
    tail = rng.standard_normal(n) * np.exp(-t / tau)
    tail[0] = 0.0
    e_tail = float(np.sum(tail * tail)) + 1e-30
    tail *= np.sqrt(max(e_budget - e_refl, 0.0) / e_tail)

    h = refl + tail
    h[0] = 1.0
    return h.astype(np.float32)


def reverb(x: np.ndarray, rt60_ms: float = 150.0, *,
           direct_to_reverb_db: float = 6.0, fs: int = 48_000,
           rng=None) -> np.ndarray:
    """Convolve with a synthetic room impulse response (same length out).

    ``direct_to_reverb_db`` is the direct-to-reverberant energy ratio
    (~6 dB is a phone at arm's length in a living room; 0 dB a far-field
    capture).
    """
    h = room_impulse_response(rt60_ms,
                              direct_to_reverb_db=direct_to_reverb_db,
                              fs=fs, rng=rng)
    y = np.convolve(x.astype(np.float64), h.astype(np.float64))
    return y[: x.size].astype(np.float32)


# ---------------------------------------------------------------------------
# speech-surrogate host
# ---------------------------------------------------------------------------
# Formant targets (F1-F3 Hz) for five vowel qualities; F4 rides ~3400 Hz.
_VOWELS = {
    "a": (730.0, 1090.0, 2440.0),
    "e": (530.0, 1840.0, 2480.0),
    "i": (270.0, 2290.0, 3010.0),
    "o": (570.0, 840.0, 2410.0),
    "u": (300.0, 870.0, 2240.0),
}


def _resonator(x: np.ndarray, f_hz: float, bw_hz: float,
               fs: int) -> np.ndarray:
    """All-pole second-order resonator (digital formant filter)."""
    r = np.exp(-np.pi * bw_hz / fs)
    w = 2.0 * np.pi * f_hz / fs
    a = [1.0, -2.0 * r * np.cos(w), r * r]
    # unity gain at the resonance peak
    b = [(1.0 - r) * np.sqrt(1.0 - 2.0 * r * np.cos(2.0 * w) + r * r)]
    return lfilter(b, a, x)


def speech_host(seconds: float, fs: int = 48_000, rng=None,
                level: float = 0.15) -> np.ndarray:
    """Reproducible wideband speech surrogate host (no corpus needed).

    The watermark's TX path is a live microphone, so speech is the host it
    meets; this synthesizes that host class deterministically (pass a
    seeded ``rng``):

    * voiced syllables: a glottal-like pulse train (pitch 95-220 Hz
      with a per-syllable contour and jitter), -12 dB/oct source tilt
      plus +6 dB/oct radiation, shaped by a 4-formant resonator
      cascade toward random vowel targets;
    * unvoiced onsets: 30-80 ms fricative noise bursts band-shaped
      2-9 kHz before ~half the syllables;
    * prosody: ~3-5 syllables/s raised-cosine syllabic envelope with
      inter-word pauses -- the amplitude nonstationarity that makes
      speech a harder host than any steady tone.

    Output RMS over the active (non-pause) regions is ``level`` (the
    scale of the 700 Hz tone hosts), then the peak is held at 0.7.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    n = int(round(seconds * fs))
    out = np.zeros(n + fs, dtype=np.float64)   # slack for the last syllable
    pos = 0
    base_pitch = float(rng.uniform(95.0, 220.0))
    vowel_names = list(_VOWELS)
    while pos < n:
        if rng.uniform() < 0.18:               # inter-word pause
            pos += int(rng.uniform(0.06, 0.25) * fs)
            continue
        dur = int(rng.uniform(0.12, 0.30) * fs)
        seg = np.zeros(dur)
        # optional unvoiced (fricative) onset
        if rng.uniform() < 0.5:
            fric_n = int(rng.uniform(0.03, 0.08) * fs)
            fric = rng.standard_normal(fric_n)
            fric = _resonator(fric, float(rng.uniform(2500.0, 6500.0)),
                              2500.0, fs)
            fric *= np.hanning(fric_n) * 0.4
            seg[:fric_n] += fric
            v0 = fric_n // 2
        else:
            v0 = 0
        # voiced part: pulse train with a pitch contour
        vn = dur - v0
        f0a = base_pitch * float(rng.uniform(0.85, 1.15))
        f0b = f0a * float(rng.uniform(0.8, 1.1))
        f0 = np.linspace(f0a, f0b, vn)
        phase = np.cumsum(f0 / fs)
        pulses = np.zeros(vn)
        pulses[np.flatnonzero(np.diff(np.floor(phase)) > 0)] = 1.0
        # source tilt (-12 dB/oct) then radiation (+6 dB/oct)
        src = lfilter([1.0], [1.0, -0.98], pulses)
        src = lfilter([1.0], [1.0, -0.98], src)
        src = np.diff(src, prepend=0.0)
        src += 0.02 * rng.standard_normal(vn)   # aspiration
        # formant cascade toward a random vowel target
        f1, f2, f3 = _VOWELS[vowel_names[int(rng.integers(5))]]
        jit = lambda f: f * float(rng.uniform(0.92, 1.08))  # noqa: E731
        y = _resonator(src, jit(f1), 90.0, fs)
        y = y + 0.8 * _resonator(src, jit(f2), 110.0, fs)
        y = y + 0.5 * _resonator(src, jit(f3), 160.0, fs)
        y = y + 0.25 * _resonator(src, 3400.0, 220.0, fs)
        env = np.sin(np.pi * np.arange(vn) / vn) ** 0.7   # syllabic envelope
        seg[v0:] += y * env
        end = min(pos + dur, out.size)
        out[pos:end] += seg[: end - pos]
        pos += dur + int(rng.uniform(0.0, 0.05) * fs)
    out = out[:n]
    active = np.abs(out) > 1e-6
    rms = float(np.sqrt(np.mean(out[active] ** 2))) if active.any() else 1.0
    out *= level / (rms + 1e-30)
    # recording-chain peak normalisation: speech crest factors run
    # 12-18 dB, and a host peaking above the mixer's headroom would leave
    # the embedder no room for the watermark (models/embedder.py caps the
    # chip scale by the remaining headroom)
    peak = float(np.abs(out).max()) if out.size else 0.0
    if peak > 0.7:
        out *= 0.7 / peak
    return out.astype(np.float32)
