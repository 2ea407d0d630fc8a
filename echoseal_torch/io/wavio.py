"""Minimal WAV read/write on the stdlib ``wave`` module.

The deployment image has no libsndfile/soundfile, so the CLI apps use this
instead.  Supports PCM 16/24/32-bit
and IEEE float32, mono or multichannel (channels averaged to mono on read).
Falls back to soundfile transparently when it IS installed, which also
unlocks FLAC etc.
"""
from __future__ import annotations

import struct
import wave

import numpy as np


def _parse_riff(path: str) -> tuple[int, int, int, int, bytes]:
    """Parse a RIFF/WAVE file -> (format_tag, channels, fs, width, data).

    The stdlib ``wave`` module rejects WAVE_FORMAT_IEEE_FLOAT (tag 3), so
    chunks are walked by hand; WAVE_FORMAT_EXTENSIBLE resolves to its
    sub-format GUID's first two bytes.
    """
    with open(path, "rb") as f:
        hdr = f.read(12)
        if hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt_tag = n_ch = fs = width = None
        data = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            body = f.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt_tag, n_ch, fs, _, _, bits = struct.unpack(
                    "<HHIIHH", body[:16])
                width = bits // 8
                if fmt_tag == 0xFFFE and size >= 40:  # EXTENSIBLE
                    fmt_tag = struct.unpack("<H", body[24:26])[0]
            elif cid == b"data":
                data = body
        if fmt_tag is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        return fmt_tag, n_ch, fs, width, data


def read(path: str) -> tuple[np.ndarray, int]:
    """Return (mono float32 samples in [-1, 1], sample_rate)."""
    try:
        import soundfile as sf  # optional

        data, fs = sf.read(path, always_2d=False)
        if data.ndim > 1:
            data = data.mean(axis=1)
        return data.astype(np.float32), int(fs)
    except ImportError:
        pass

    fmt_tag, n_ch, fs, width, raw = _parse_riff(path)

    if fmt_tag == 3:  # IEEE float
        dt = "<f4" if width == 4 else "<f8"
        x = np.frombuffer(raw, dtype=dt).astype(np.float32)
        if n_ch > 1:
            x = x.reshape(-1, n_ch).mean(axis=1)
        return x.astype(np.float32), fs

    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (b[:, 0].astype(np.int32)
               | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        val = np.where(val & 0x800000, val - (1 << 24), val)
        x = val.astype(np.float32) / 8388608.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")

    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x.astype(np.float32), fs


def write(path: str, samples: np.ndarray, fs: int,
          subtype: str = "float32") -> None:
    """Write mono audio.  subtype: 'float32' or 'pcm16'."""
    x = np.asarray(samples, dtype=np.float32).ravel()
    if subtype == "pcm16":
        data = (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(fs)
            w.writeframes(data)
        return
    # IEEE float32 WAV: the stdlib writer only does PCM, so write the
    # header by hand (format tag 3)
    data = x.astype("<f4").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, fs, fs * 4, 4, 32)
    hdr += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(hdr + data)
