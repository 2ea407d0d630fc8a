"""Streaming RX: continuous watermark monitoring over a live stream.

A deployment watching a feed needs verdicts as audio ARRIVES.  The monitor
keeps a sliding window over the incoming sample stream and re-verifies it
every ``hop_s`` seconds of new audio, emitting one ``MonitorEvent`` per
completed window:

    mon = StreamMonitor(key, profile="v2")
    for block in capture():              # any block size, any cadence
        for ev in mon.feed(block):
            if ev.result.authentic:
                alarm_ok(ev.t_start, ev.result.frame_ctr)

Design notes:

* The underlying verifier is the ordinary single-clip engine
  (`WatermarkDetector` / `RobustVerifier`), so every window gets the full
  fallback ladder.
* The session anti-replay latch is carried ACROSS windows (the detector
  instance persists), so a stream that switches to frames sealed in a
  different TX session flips to rejections -- exactly the single-clip
  semantics extended in time.
* Window/hop default to 4 s / 2 s: every frame appears in >=2 windows, so
  a verdict lags the audio by at most ~hop + verify latency.
* Device rule: ``device=None`` means CUDA and raises without a card; the
  CPU only with ``device="cpu"``.  A monitor built on a given ``verifier``
  runs where that verifier lives.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from echoseal_torch.models.detector import (
    MIN_CLIP_SECONDS,
    VerifyResult,
    WatermarkDetector,
)


@dataclass
class MonitorEvent:
    """Verdict for one analysis window."""

    t_start: float            # window start, seconds of stream time
    t_end: float
    result: VerifyResult


class StreamMonitor:
    """Sliding-window continuous verifier over a sample stream."""

    def __init__(self, key32: bytes, *, fs: int = 48_000,
                 profile: str = "compat", window_s: float = 4.0,
                 hop_s: float = 2.0, list_size: int = 32,
                 verifier=None,
                 device: str | torch.device | None = None) -> None:
        if hop_s <= 0 or window_s < hop_s:
            raise ValueError("need 0 < hop_s <= window_s")
        self.fs = fs
        self.window = int(window_s * fs)
        self.hop = int(hop_s * fs)
        if verifier is not None:
            self._det = verifier
        elif profile == "v2":
            from echoseal_torch.models.robust import RobustVerifier

            self._det = RobustVerifier(key32, fs_target=fs,
                                       list_size=list_size, device=device)
        else:
            self._det = WatermarkDetector(key32, fs_target=fs,
                                          list_size=list_size, device=device)
        self._buf = np.zeros(0, dtype=np.float32)
        self._pos = 0             # stream index of _buf[0]

    # ------------------------------------------------------------------ API
    def feed(self, samples: np.ndarray) -> list[MonitorEvent]:
        """Append samples; verify every window that completed."""
        x = np.asarray(samples, dtype=np.float32).ravel()
        self._buf = np.concatenate([self._buf, x])
        events: list[MonitorEvent] = []
        while self._buf.size >= self.window:
            events.append(self._verify_window(self._buf[: self.window]))
            self._buf = self._buf[self.hop :]
            self._pos += self.hop
        return events

    def flush(self) -> list[MonitorEvent]:
        """Verify whatever trailing audio remains (if long enough)."""
        if self._buf.size < int(MIN_CLIP_SECONDS * self.fs):
            return []
        ev = self._verify_window(self._buf)
        self._pos += self._buf.size
        self._buf = np.zeros(0, dtype=np.float32)
        return [ev]

    @property
    def session_nonce(self) -> bytes | None:
        return self._det.session_nonce

    # ------------------------------------------------------------ internals
    def _verify_window(self, win: np.ndarray) -> MonitorEvent:
        res = self._det.verify_detailed(win, self.fs)
        return MonitorEvent(
            t_start=self._pos / self.fs,
            t_end=(self._pos + win.size) / self.fs,
            result=res,
        )


class BatchStreamMonitor:
    """Continuous monitoring at SERVING throughput: windows as batch rows.

    ``StreamMonitor`` pays one full single-clip ladder per window; at the
    default 4 s / 2 s cadence that is half the single-clip verify cost per
    second of stream -- fine for one feed, wasteful for many.  This variant
    collects every window that completed during a ``feed`` call and
    verifies them as rows of ONE serving-tier batch
    (``RobustBatchVerifier`` / ``BatchVerifier``), so continuous
    monitoring pays the batched pipeline's per-clip cost instead.

    Semantics differences vs ``StreamMonitor`` (serving-tier semantics,
    models/pipeline.py finish_host_detailed):

    * accepted events carry the accepting rung's detail (``frame_ctr``,
      ``session_nonce``, ``stage`` in {'hard','scl','ext_ctr'}) via the
      pipeline's per-clip ``ClipDetail`` plumbing, so a monitoring
      deployment can tell WHICH session authenticated without re-running
      the single-clip tier; rejected events carry ``stage='batch'``;
    * anti-replay is the CALLER's hook: pass ``expected_nonce`` to pin the
      session; without it any authentic session verifies (multi-tenant).

    A batch holds exactly the completed windows (at most ``MAX_ROWS``),
    each padded to ``window + 16384`` samples.
    """

    def __init__(self, key32: bytes, *, fs: int = 48_000,
                 profile: str = "v2", window_s: float = 4.0,
                 hop_s: float = 2.0, expected_nonce: bytes | None = None,
                 verifier=None,
                 device: str | torch.device | None = None) -> None:
        if hop_s <= 0 or window_s < hop_s:
            raise ValueError("need 0 < hop_s <= window_s")
        self.fs = fs
        self.window = int(window_s * fs)
        self.hop = int(hop_s * fs)
        self.expected_nonce = expected_nonce
        if verifier is not None:
            self._bv = verifier
        elif profile == "v2":
            from echoseal_torch.models.pipeline import RobustBatchVerifier

            self._bv = RobustBatchVerifier(key32, fs=fs, device=device)
        else:
            from echoseal_torch.models.pipeline import BatchVerifier

            self._bv = BatchVerifier(key32, fs=fs, device=device)
        # fixed pad (window + sync margin), NOT a power of two: the sync
        # conv runs over every padded sample
        self._tpad = self.window + 16384
        self._buf = np.zeros(0, dtype=np.float32)
        self._pos = 0

    # ------------------------------------------------------------------ API
    def feed(self, samples: np.ndarray) -> list[MonitorEvent]:
        """Append samples; verify every completed window in ONE dispatch."""
        x = np.asarray(samples, dtype=np.float32).ravel()
        self._buf = np.concatenate([self._buf, x])
        wins: list[np.ndarray] = []
        starts: list[int] = []
        while self._buf.size >= self.window:
            wins.append(self._buf[: self.window])
            starts.append(self._pos)
            self._buf = self._buf[self.hop :]
            self._pos += self.hop
        events = self._verify_windows(wins, starts)
        if wins:
            # detach the tail from the concatenated feed buffer: a numpy
            # VIEW keeps the WHOLE recording alive via .base (a 1 h feed
            # would pin ~690 MB behind a <4 s remainder)
            self._buf = self._buf.copy()
        return events

    def flush(self) -> list[MonitorEvent]:
        """Verify whatever trailing audio remains (if long enough)."""
        if self._buf.size < int(MIN_CLIP_SECONDS * self.fs):
            return []
        ev = self._verify_windows([self._buf], [self._pos])
        self._pos += self._buf.size
        self._buf = np.zeros(0, dtype=np.float32)
        return ev

    # ------------------------------------------------------------ internals
    MAX_ROWS = 128     # per-dispatch cap: one feed() over a long recording
    # must not build an unbounded batch (a 1 h file is ~1800 windows --
    # the sync-corr intermediate alone would exceed device memory)

    def _verify_windows(self, wins, starts) -> list[MonitorEvent]:
        if not wins:
            return []
        events: list[MonitorEvent] = []
        for c0 in range(0, len(wins), self.MAX_ROWS):
            wchunk = wins[c0 : c0 + self.MAX_ROWS]
            schunk = starts[c0 : c0 + self.MAX_ROWS]
            rows = len(wchunk)
            batch = np.zeros((rows, self._tpad), np.float32)
            nv = np.zeros(rows, np.int32)
            for i, w in enumerate(wchunk):
                batch[i, : w.size] = w
                nv[i] = w.size
            details: dict = {}
            verdicts = self._bv.verify_batch(
                batch, nv, expected_nonce=self.expected_nonce,
                details=details)
            for i, (w, s) in enumerate(zip(wchunk, schunk)):
                d = details.get(i)
                res = (VerifyResult(True, frame_ctr=d.frame_ctr,
                                    session_nonce=d.session_nonce,
                                    stage=d.stage)
                       if bool(verdicts[i]) and d is not None
                       else VerifyResult(bool(verdicts[i]), stage="batch"))
                events.append(MonitorEvent(
                    t_start=s / self.fs,
                    t_end=(s + w.size) / self.fs,
                    result=res,
                ))
        return events
