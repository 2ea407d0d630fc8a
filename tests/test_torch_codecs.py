"""echoseal_torch MPEG-1 Layer II/III codecs and window pair vs echoseal_tpu's.

Both packages' codecs are host numpy modules, so everything here is exact:
the window pair, the filterbank, the psychoacoustic pieces and the
Huffman tables are bit-identical, the encoded bitstreams byte-identical,
and the decoded and round-tripped samples bit-identical.  The window-pair
designer (``diagnostics/design_pqmf.py``) is held within 1e-9.
"""
import contextlib
import io

import numpy as np
import pytest

from echoseal_torch.data import pqmf512 as Pq
from echoseal_torch.diagnostics import design_pqmf as Pd
from echoseal_torch.utils import mpeg1 as P2
from echoseal_torch.utils import mpeg1_l3 as P3
from echoseal_tpu.data import pqmf512 as Jq
from echoseal_tpu.diagnostics import design_pqmf as Jd
from echoseal_tpu.utils import mpeg1 as J2
from echoseal_tpu.utils import mpeg1_l3 as J3
from torch_port_util import two_torch_threads  # noqa: F401

FS = 48_000
LAYERS = {"l2": (P2, J2), "l3": (P3, J3)}


@pytest.fixture(scope="module")
def clip():
    """0.3 s: a 700 Hz tone, a 17 kHz tone and white noise, seeded."""
    rng = np.random.default_rng(3)
    t = np.arange(int(0.3 * FS)) / FS
    return (0.2 * np.sin(2 * np.pi * 700 * t)
            + 0.05 * np.sin(2 * np.pi * 17_000 * t)
            + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def streams(clip):
    """{(layer, kbps): (port bytes, JAX bytes)}, each encoded once."""
    return {(name, kbps): (P.encode(clip, FS, kbps), J.encode(clip, FS, kbps))
            for name, (P, J) in LAYERS.items() for kbps in (64, 128)}


def test_window_pair_and_delay_equal():
    (pc, pd), (jc, jd) = Pq.window_pair(), Jq.window_pair()
    assert pc.shape == pd.shape == (512,) and pc.dtype == np.float64
    assert np.array_equal(pc, jc) and np.array_equal(pd, jd)
    assert Pq.DELAY == Jq.DELAY == 481
    assert Pq._B64 == Jq._B64


def test_analyze_synthesize_equal():
    x = np.random.default_rng(4).standard_normal(32 * 97)
    s_p, s_j = P2.analyze(x), J2.analyze(x)
    assert np.array_equal(s_p, s_j)
    assert np.array_equal(P2.synthesize(s_p), J2.synthesize(s_j))


def test_psychoacoustic_pieces_equal():
    f = np.linspace(20.0, 23_000.0, 333)
    assert np.array_equal(P2._bark(f), J2._bark(f))
    assert np.array_equal(P2._quiet_threshold_db(f), J2._quiet_threshold_db(f))
    for a, b in zip(P2._psy_consts(FS), J2._psy_consts(FS)):
        assert np.array_equal(a, b)
    rng = np.random.default_rng(5)
    frame = rng.standard_normal(P2.FRAME_SAMPLES)
    scf_max = np.abs(rng.standard_normal(P2.SBLIMIT)) + 0.1
    smr = P2._frame_smr(frame, scf_max, FS)
    assert np.array_equal(smr, J2._frame_smr(frame, scf_max, FS))
    cost = rng.integers(0, 20, P2.SBLIMIT)
    for budget in (200, 1500, 4000):
        assert np.array_equal(P2._allocate(smr, cost, budget),
                              J2._allocate(smr, cost, budget))


def test_bit_io_and_scfsi_equal():
    w_p, w_j = P2._BitWriter(), J2._BitWriter()
    for v, n in ((5, 3), (0x3AD2, 16), (1, 1), (1023, 10), (77, 7)):
        w_p.write(v, n)
        w_j.write(v, n)
    blob = w_p.getvalue()
    assert blob == w_j.getvalue()
    r = P2._BitReader(blob)
    assert [r.read(n) for n in (3, 16, 1, 10, 7)] == [5, 0x3AD2, 1, 1023, 77]
    for idx3 in ((4, 4, 4), (4, 4, 9), (1, 6, 6), (1, 2, 3)):
        assert P2._scfsi_pick(np.array(idx3)) == J2._scfsi_pick(np.array(idx3))


def test_layer3_transforms_and_tables_equal():
    rng = np.random.default_rng(6)
    s = rng.standard_normal((18 * 6, P3.SUBBANDS))
    X = P3._mdct_granules(s)
    assert np.array_equal(X, J3._mdct_granules(s))
    assert np.array_equal(P3._imdct_granules(X), J3._imdct_granules(X))
    for inverse in (False, True):
        assert np.array_equal(P3._alias_reduce(X, inverse),
                              J3._alias_reduce(X, inverse))
    for a, b in zip(P3._pair_tables() + P3._quad_tables(),
                    J3._pair_tables() + J3._quad_tables()):
        assert np.array_equal(a.len, b.len) and np.array_equal(a.code, b.code)
        assert a.tree == b.tree
    q = np.abs(rng.integers(-20, 20, P3.GRANULE))
    q[400:] = 0
    q[300:400] = q[300:400] % 2
    assert P3._split_regions(q) == J3._split_regions(q)
    assert P3._granule_bits(q) == J3._granule_bits(q)


@pytest.mark.parametrize("kbps", [64, 128])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_encode_decode_roundtrip_equal(clip, streams, layer, kbps):
    P, J = LAYERS[layer]
    blob_p, blob_j = streams[(layer, kbps)]
    assert isinstance(blob_p, bytes) and blob_p == blob_j
    (y_p, fs_p), (y_j, fs_j) = P.decode(blob_p), J.decode(blob_j)
    assert fs_p == fs_j == FS
    assert np.array_equal(y_p, y_j)
    r_p, r_j = P.roundtrip(clip, FS, kbps), J.roundtrip(clip, FS, kbps)
    assert r_p.shape == clip.shape and r_p.dtype == r_j.dtype
    assert np.array_equal(r_p, r_j)


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_bad_stream_raises_in_both(streams, layer):
    P, J = LAYERS[layer]
    good = streams[(layer, 64)][0]
    for blob in (b"\x00" * 16, bytes([good[0] ^ 0xFF]) + good[1:]):
        with pytest.raises(ValueError):
            P.decode(blob)
        with pytest.raises(ValueError):
            J.decode(blob)


@pytest.fixture(scope="module")
def designs():
    """One ``design(n_iter=1)`` per package (about 10 s each)."""
    out = []
    for mod in (Pd, Jd):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            C, D = mod.design(n_iter=1)
        out.append((C, D, buf.getvalue()))
    return out


def test_design_pqmf_one_iteration_equal(designs):
    (pc, pd, p_out), (jc, jd, j_out) = designs
    assert pc.shape == pd.shape == (512,)
    np.testing.assert_allclose(pc, jc, rtol=0, atol=1e-9)
    np.testing.assert_allclose(pd, jd, rtol=0, atol=1e-9)
    assert p_out == j_out and p_out.startswith("iter 0:")
