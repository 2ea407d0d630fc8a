"""The benchmark's one traffic generator.

It reads a configuration file (``portbench/configs/<name>.json``: the
waveform, its transmitter and the rows the verifier takes) and a traffic
file (``portbench/traffic/<name>.json``: clips per batch, clip length,
distinct batches, the channel), and makes every input from ``--seed``
with the frozen transmitter under ``portbench/ref``.  The same seed gives
the same inputs; every seed gives the same sizes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.ref.bandplan import hop_schedule
from portbench.ref.channels import codec_sim
from portbench.ref.crypto import SecureChannel
from portbench.ref.params import FRAME_LEN
from portbench.ref.profiles import ROBUST
from portbench.ref.tx import RobustEmbedder, frames_np


@dataclasses.dataclass
class Batch:
    """One batch of clips on the device, with what the TX put in them."""

    clips: torch.Tensor          # (B, row) float32, zero past each clip
    n_valid: torch.Tensor        # (B,) int32
    starts: np.ndarray           # (B,) first stream sample of each clip
    seconds: float               # audio seconds in the batch


@dataclasses.dataclass
class Stream:
    samples: np.ndarray          # float32
    nonce: bytes                 # the session nonce every frame carries
    span: int                    # samples per frame


def _host(spec: dict | None, n: int, fs: int) -> np.ndarray:
    if spec is None:
        return np.zeros(n, np.float32)
    if spec["kind"] == "tone":
        t = np.arange(n) / fs
        return (spec["amp"] * np.sin(2 * np.pi * spec["hz"] * t)
                ).astype(np.float32)
    raise ValueError(f"unknown host {spec['kind']!r}")


def make_stream(config: dict, traffic: dict, rng: np.random.Generator
                ) -> Stream:
    """The seeded TX stream of one session, through the traffic's channel."""
    key = bytes.fromhex(config["key_hex"])
    tx, fs = config["tx"], config["fs"]
    if tx["kind"] == "compat_frames":
        nonce = rng.bytes(8)
        n = tx["stream_frames"]
        frames = frames_np(SecureChannel(key), hop_schedule(key),
                           np.arange(n), nonce, fs=fs, rng=rng)
        x = frames.reshape(-1) * np.float32(10.0 ** (tx["level_dbfs"] / 20))
        span = FRAME_LEN
    elif tx["kind"] == "v2_stream":
        emb = RobustEmbedder(key, rng=rng)
        nonce = emb._session_nonce
        x = emb.process(_host(tx.get("host"), int(tx["stream_s"] * fs), fs))
        span = ROBUST.span
    else:
        raise ValueError(f"unknown tx {tx['kind']!r}")
    ch = traffic.get("channel")
    if ch is not None:
        if ch["kind"] != "codec_sim":
            raise ValueError(f"unknown channel {ch['kind']!r}")
        x = codec_sim(x, ch["bitrate_kbps"], fs)
    return Stream(np.ascontiguousarray(x, np.float32), nonce, span)


def cut_starts(stream: Stream, n: int, T: int, align: str,
               rng: np.random.Generator) -> np.ndarray:
    """``n`` clip starts: frame-aligned or at any sample."""
    if align == "frame":
        frames = stream.samples.size // stream.span
        return rng.integers(0, frames - -(-T // stream.span), n) * stream.span
    return rng.integers(0, stream.samples.size - T, n)


def make_batches(config: dict, traffic: dict, seed: int, device
                 ) -> tuple[Stream, list[Batch]]:
    """The stream and the traffic's distinct batches, on ``device``."""
    rng = np.random.default_rng(seed)
    stream = make_stream(config, traffic, rng)
    fs = config["fs"]
    T = int(round(traffic["clip_s"] * fs))
    B = traffic["clips"]
    dev_stream = torch.as_tensor(stream.samples, device=device)
    view = dev_stream.unfold(0, T, 1)
    out = []
    align = traffic.get("align", config["tx"]["align"])
    for _ in range(traffic["batches"]):
        starts = cut_starts(stream, B, T, align, rng)
        clips = torch.zeros(B, T + config["row_pad"], device=device)
        clips[:, :T] = view[torch.as_tensor(starts, device=device)]
        out.append(Batch(clips, torch.full((B,), T, dtype=torch.int32,
                                           device=device),
                         starts, B * T / fs))
    return stream, out


@dataclasses.dataclass
class Cut:
    """One single-clip request: host audio and where it was cut."""

    audio: np.ndarray            # (T,) float32
    start: int


def make_cuts(config: dict, traffic: dict, seed: int
              ) -> tuple[Stream, list[Cut], np.ndarray]:
    """The stream, a pool of distinct cuts, and the order of requests over
    the pool (each cut once per pass, the passes in seeded orders)."""
    rng = np.random.default_rng(seed)
    stream = make_stream(config, traffic, rng)
    T = int(round(traffic["clip_s"] * config["fs"]))
    align = traffic.get("align", config["tx"]["align"])
    n = traffic["pool"]
    starts = cut_starts(stream, n, T, align, rng)
    while np.unique(starts).size < n:
        starts = cut_starts(stream, n, T, align, rng)
    cuts = [Cut(stream.samples[s:s + T].copy(), int(s)) for s in starts]
    order = np.concatenate([rng.permutation(n) for _ in range(64)])
    return stream, cuts, order
