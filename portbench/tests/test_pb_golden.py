"""The frozen transmitter and crypto under ``portbench/ref`` are
wire-identical: they reproduce the repository's golden vectors."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from portbench.ref.bandplan import hop_schedule
from portbench.ref.crypto import SecureChannel
from portbench.ref.polar import encode_np
from portbench.ref.sequences import mls63
from portbench.ref.tx import frames_np, synthesize_frame_np
from portbench.tests.pb_fixtures import two_threads  # noqa: F401

GOLD = np.load(Path(__file__).resolve().parents[2] / "tests" / "golden"
               / "reference_vectors.npz")
KEY = bytes.fromhex("aa" * 32)


@pytest.mark.parametrize("ctr", [0, 5, 1000])
def test_frozen_frame_matches_golden(ctr):
    frame = synthesize_frame_np(SecureChannel(KEY), hop_schedule(KEY), ctr,
                                GOLD["payloads"][0].tobytes())
    np.testing.assert_allclose(frame, GOLD[f"frame_{ctr}"], rtol=1e-5,
                               atol=1e-6)


def test_frozen_pn_hop_mls_aead_match_golden():
    sec = SecureChannel(KEY)
    for ctr in (0, 1, 255, 1024, 65537):
        np.testing.assert_array_equal(sec.pn_bits(ctr, 1215),
                                      GOLD[f"pn_{ctr}"])
    np.testing.assert_array_equal(
        hop_schedule(KEY).indices(np.arange(512)), GOLD["band_idx"])
    np.testing.assert_array_equal(mls63(), GOLD["mls63"])
    assert sec.open(GOLD["sealed_blob"].tobytes()) == \
        GOLD["sealed_plain"].tobytes()
    for i in range(3):
        np.testing.assert_array_equal(encode_np(GOLD["payloads"][i].tobytes()),
                                      GOLD["codewords"][i])


def test_frames_np_is_frame_by_frame_synthesis():
    """The batch TX the traffic uses equals the single-frame synthesis."""
    sec, hop = SecureChannel(KEY), hop_schedule(KEY)
    rng = np.random.default_rng(7)
    frames = frames_np(sec, hop, np.array([3, 4]), b"\x01" * 8, rng=rng)
    assert frames.shape == (2, 1215) and np.isfinite(frames).all()
    assert np.abs(frames).max() <= 3.0
