"""echoseal_torch host core: crypto, sequences, band plan, TX frames.

Each port function is held against the golden reference vectors and
against its ``echoseal_tpu`` twin on the same inputs; everything here is
exact (bytes, bits, integers), except frame chips, which carry the golden
test's own float tolerance (tests/test_embedder.py).
"""
import re
from pathlib import Path

import numpy as np
import pytest

from echoseal_torch.core import crypto as pcrypto
from echoseal_torch.core.bandplan import band_index, hop_schedule
from echoseal_torch.core.params import FRAME_LEN, TxParams
from echoseal_torch.core.sequences import header_bits_batch, mls63
from echoseal_torch.data.q1024 import reliability_sequence
from echoseal_torch.models.embedder import (
    WatermarkEmbedder,
    frames_np,
    synthesize_frame_np,
)
from echoseal_tpu.core import crypto as jcrypto
from echoseal_tpu.core import sequences as jseq
from echoseal_tpu.data.q1024 import reliability_sequence as j_reliability

ROOT = Path(__file__).resolve().parent.parent
GOLD = np.load(ROOT / "tests" / "golden" / "reference_vectors.npz")


@pytest.fixture(scope="module")
def psec(key32):
    return pcrypto.SecureChannel(key32)


@pytest.fixture(scope="module")
def jsec(key32):
    return jcrypto.SecureChannel(key32)


def test_port_imports_no_jax_tpu_or_cryptography():
    """The port's sources, chip_smoke.py and the test helper it imports
    import none of the three."""
    banned = re.compile(
        r"^\s*(import|from)\s+(jax|echoseal_tpu|cryptography)\b", re.M)
    files = sorted((ROOT / "echoseal_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_port_util.py"]
    assert len(files) > 10
    # the walk reaches every sub-package, the CLIs and the I/O included
    assert {"cli", "io", "models", "ops", "core", "utils", "diagnostics",
            "data", "native", "gui", "parallel"} <= {
        f.parent.name for f in files}
    bad = [str(f) for f in files if banned.search(f.read_text())]
    assert bad == []


def test_kdf_matches_jax_package(key32):
    assert pcrypto.derive_subkeys(key32) == jcrypto.derive_subkeys(key32)
    with pytest.raises(ValueError):
        pcrypto.derive_subkeys(bytes(16))


@pytest.mark.parametrize("ctr", [0, 1, 255, 1024, 65537])
def test_pn_bits_golden(psec, ctr):
    np.testing.assert_array_equal(psec.pn_bits(ctr, 1215), GOLD[f"pn_{ctr}"])


def test_pn_batch_matches_jax_package(psec, jsec, rng):
    ctrs = np.concatenate([np.arange(300), rng.integers(0, 2**40, 300)])
    np.testing.assert_array_equal(psec.pn_bits_batch(ctrs, FRAME_LEN),
                                  jsec.pn_bits_batch(ctrs, FRAME_LEN))
    np.testing.assert_array_equal(psec.pn_bits(0, 128), GOLD["hdr_pn"])


def test_band_index_golden(key32):
    idx = np.array([band_index(key32, c) for c in range(512)])
    np.testing.assert_array_equal(idx, GOLD["band_idx"])
    np.testing.assert_array_equal(hop_schedule(key32).indices(np.arange(512)),
                                  GOLD["band_idx"])


def test_opens_reference_blob(psec):
    assert psec.open(GOLD["sealed_blob"].tobytes()) == \
        GOLD["sealed_plain"].tobytes()


def test_seal_open_cross_package(psec, jsec):
    pt = bytes(range(27))
    blob = psec.seal(pt)
    assert len(blob) == 55
    assert jsec.open(blob) == pt                 # port-sealed, JAX opens
    assert psec.open(jsec.seal(pt)) == pt        # JAX-sealed, port opens


@pytest.mark.parametrize("n", [0, 1, 27, 63, 64, 65, 200])
def test_aead_lengths_cross_package(psec, jsec, n, rng):
    pt = rng.bytes(n)
    assert jsec.open(psec.seal(pt)) == pt
    assert psec.open(jsec.seal(pt)) == pt


def test_tampered_and_wrong_key_rejected(psec, jsec):
    blob = bytearray(jsec.seal(bytes(range(27))))
    blob[20] ^= 1
    with pytest.raises(pcrypto.InvalidTag):
        psec.open(bytes(blob))
    assert psec.open_any_layout(bytes(blob)) == (None, None)
    other = pcrypto.SecureChannel(bytes(32))
    with pytest.raises(pcrypto.InvalidTag):
        other.open(psec.seal(bytes(27)))
    with pytest.raises(ValueError):
        psec.open(bytes(20))


def test_open_any_layout_matches_jax_package(psec, jsec, rng):
    blobs = []
    for i in range(12):
        b = jsec.seal(rng.bytes(27))
        if i % 3 == 1:
            b = b[12:] + b[:12]                  # nonce-tail layout
        elif i % 3 == 2:
            b = rng.bytes(55)                    # garbage
        blobs.append(b)
    blobs += [b"", rng.bytes(11), rng.bytes(20)]
    want = [jsec.open_any_layout(b) for b in blobs]
    assert psec.open_any_layout_many(blobs) == want
    assert [psec.open_any_layout(b) for b in blobs] == want


def test_sequences_and_tables_match():
    np.testing.assert_array_equal(mls63(), GOLD["mls63"])
    np.testing.assert_array_equal(TxParams().preamble, GOLD["mls63"])
    ctrs = np.array([0, 1, 0xFFFF, 0x12345])
    np.testing.assert_array_equal(header_bits_batch(ctrs),
                                  jseq.header_bits_batch(ctrs))
    np.testing.assert_array_equal(reliability_sequence(), j_reliability())


@pytest.mark.parametrize("ctr", [0, 5, 1000])
def test_frame_chips_golden(key32, psec, ctr):
    frame = synthesize_frame_np(psec, hop_schedule(key32), ctr,
                                GOLD["payloads"][0].tobytes())
    np.testing.assert_allclose(frame, GOLD[f"frame_{ctr}"],
                               rtol=1e-5, atol=1e-6)


def test_tx_matches_jax_package(key32, psec, jsec, monkeypatch):
    """Batch and streaming TX equal the JAX package's host TX.

    With ``secrets.token_bytes`` pinned to zeros both packages seal the
    same plaintexts under the same nonces, so frames must agree to the
    float64 synthesis' rounding.
    """
    import secrets

    from echoseal_tpu.core.bandplan import hop_schedule as j_hop
    from echoseal_tpu.models.embedder import WatermarkEmbedder as JEmbedder
    from echoseal_tpu.models.embedder import synthesize_frame_np as j_synth

    monkeypatch.setattr(secrets, "token_bytes", lambda n: bytes(n))
    ctrs = np.array([3, 4, 70_000])
    fr = frames_np(psec, hop_schedule(key32), ctrs, b"sessionX")
    assert fr.shape == (3, FRAME_LEN) and fr.dtype == np.float32
    for i, c in enumerate(ctrs):
        plain = b"ESAL" + int(c).to_bytes(4, "big") + b"sessionX" + bytes(11)
        want = j_synth(jsec, j_hop(key32), int(c), jsec.seal(plain))
        np.testing.assert_allclose(fr[i], want, rtol=1e-6, atol=1e-7)

    host = (0.1 * np.sin(np.arange(3000) / 7.0)).astype(np.float32)
    got = WatermarkEmbedder(key32).process(host)
    want = JEmbedder(key32).process(host)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_seeded_tx_is_reproducible(key32, psec):
    """``frames_np(rng=...)`` draws every random byte from the generator."""
    hop = hop_schedule(key32)
    ctrs = np.array([7, 8, 9])
    a = frames_np(psec, hop, ctrs, rng=np.random.default_rng(11))
    b = frames_np(psec, hop, ctrs, rng=np.random.default_rng(11))
    c = frames_np(psec, hop, ctrs, rng=np.random.default_rng(12))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    pts = [bytes([i]) * 27 for i in range(3)]
    nonces = [bytes([i]) * 12 for i in range(3)]
    blobs = psec.seal_many(pts, nonces)
    assert [bl[:12] for bl in blobs] == nonces
    assert [psec.open(bl) for bl in blobs] == pts
