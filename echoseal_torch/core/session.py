"""Session state checkpoint / resume.

The reference keeps TX/RX session state implicitly in memory (frame
counter + 8-byte session nonce on TX, the anti-replay nonce latch on RX)
and loses it on restart.  Here both sides can snapshot to a small JSON
blob and resume exactly -- a crashed transmitter continues its counter
sequence instead of replaying counters (which would repeat PN streams),
and a restarted verifier keeps its anti-replay latch.
"""
from __future__ import annotations

import base64
import json
from pathlib import Path


def save_tx(embedder, path: str | Path) -> None:
    state = {
        "kind": "echoseal-tx-session",
        "frame_ctr": int(embedder.frame_ctr),
        "session_nonce": base64.b64encode(embedder._session_nonce).decode(),
        "chip_buf": base64.b64encode(
            embedder._chip_buf.astype("<f4").tobytes()).decode(),
    }
    Path(path).write_text(json.dumps(state))


def load_tx(embedder, path: str | Path) -> None:
    import numpy as np

    state = json.loads(Path(path).read_text())
    if state.get("kind") != "echoseal-tx-session":
        raise ValueError("not a TX session checkpoint")
    embedder.frame_ctr = int(state["frame_ctr"])
    embedder._session_nonce = base64.b64decode(state["session_nonce"])
    embedder._chip_buf = np.frombuffer(
        base64.b64decode(state["chip_buf"]), dtype="<f4").copy()


def save_rx(detector, path: str | Path) -> None:
    nonce = detector.session_nonce
    state = {
        "kind": "echoseal-rx-session",
        "session_nonce": base64.b64encode(nonce).decode() if nonce else None,
    }
    Path(path).write_text(json.dumps(state))


def load_rx(detector, path: str | Path) -> None:
    state = json.loads(Path(path).read_text())
    if state.get("kind") != "echoseal-rx-session":
        raise ValueError("not an RX session checkpoint")
    nonce = state.get("session_nonce")
    detector.session_nonce = base64.b64decode(nonce) if nonce else None
