"""echoseal_torch single-clip v2 verify vs echoseal_tpu's, on the CPU.

The same seeded clips (TX through the port's seeded ``RobustEmbedder``,
which equals the JAX one) and the same tables go through
``RobustVerifier`` of both packages.

What is held, and why (ROADMAP C3):

* ``_robust_scan``: peak positions and header reads exact, peak scores and
  header scores within 1e-4; each chip within 1e-4 of its row's largest
  chip (the LS product sums 9720 float32 terms in another order).
* ``estimate_scale`` returns the same grid factor.
* ``VerifyResult``: ``authentic``, ``stage``, ``frame_ctr``, ``band``,
  ``peak_pos`` and ``timescale`` equal on the seeded cases of
  tests/test_robust.py: loud host, MP3-sim, silence host, wrong key, short
  clip, noise, a 44.1 kHz capture, a caller grid, and an unknown factor
  through the scaled-template scan; the peak lists are equal too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echoseal_torch.convert import VERIFIER_TABLE_DTYPES, numpy_tables_of
from echoseal_torch.core.profiles import ROBUST
from echoseal_torch.models import robust as PR
from echoseal_torch.utils.channels import time_scale
from echoseal_tpu.models import robust as JR
from echoseal_tpu.utils import channels as jchannels
from torch_port_util import two_torch_threads  # noqa: F401

FS = 48_000
TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = ("authentic", "stage", "frame_ctr", "band", "peak_pos", "timescale")
BAD_KEY = bytes.fromhex("33" * 32)


def pair(key, **kw):
    """The JAX verifier and the port's on identical tables."""
    jv = JR.RobustVerifier(key, **kw)
    pv = PR.RobustVerifier.from_tables(
        key, numpy_tables_of(jv, VERIFIER_TABLE_DTYPES), device="cpu", **kw)
    return jv, pv


@pytest.fixture(scope="module")
def vers(key32):
    return pair(key32)


@pytest.fixture(scope="module")
def wm_loud_host(key32):
    host = (0.2 * np.sin(2 * np.pi * 700 * np.arange(4 * FS) / FS)
            ).astype(np.float32)
    return PR.RobustEmbedder(key32, rng=np.random.default_rng(1)).process(host)


def both_verify(vers, audio, fs=FS):
    """``verify_detailed`` of both packages from a fresh latch; asserts the
    fields and the peak lists are equal."""
    jv, pv = vers
    jv.session_nonce = pv.session_nonce = None
    rj, rp = jv.verify_detailed(audio, fs), pv.verify_detailed(audio, fs)
    for f in FIELDS:
        assert getattr(rp, f) == getattr(rj, f), (f, rp, rj)
    assert (rp.peaks is None) == (rj.peaks is None)
    if rp.peaks is not None:
        np.testing.assert_array_equal(rp.peaks, rj.peaks)
    assert pv.session_nonce == jv.session_nonce
    return rp


# ---------------------------------------------------------------- the stage
def test_robust_scan_matches_jax(vers, wm_loud_host):
    jv, pv = vers
    span = ROBUST.span
    clip = wm_loud_host[5000:5000 + int(3.2 * FS)]
    Tpad = 1 << 18
    x = np.zeros(Tpad, np.float32)
    x[: clip.size] = clip
    jo = JR._robust_scan(jnp.asarray(x), jnp.int32(clip.size), jv._templates,
                         jv._m_stack, jv._hdr_pn_sy, jv._pre_sy, span=span)
    jo = {k: np.asarray(v) for k, v in jo.items()}
    po = {k: v.numpy() for k, v in PR._robust_scan(
        torch.from_numpy(x), clip.size, pv.tables, span=span).items()}
    assert set(po) == set(jo)
    for k in ("peak_idx", "hdr_ok", "hdr_lo16"):
        np.testing.assert_array_equal(po[k], jo[k], err_msg=k)
    for k in ("peak_val", "pre", "hdr_score"):
        np.testing.assert_allclose(po[k], jo[k], err_msg=k, **TOL)
    assert po["chips"].shape == jo["chips"].shape == (4, 2, 4, 1215)
    row_err = np.abs(po["chips"] - jo["chips"]).max(-1)
    assert np.all(row_err <= 1e-4 * np.abs(jo["chips"]).max(-1)), row_err.max()
    assert jo["hdr_ok"].any()


def test_port_designs_equal_jax_tables(key32, vers):
    """One LS matrix designed by the port (the rest: test_torch_robust.py)."""
    tables = vers[1].tables
    assert tables["m_stack"].shape == (4, 2, 1215, 9720)
    lo, hi = PR.BAND_PLAN[2]
    np.testing.assert_array_equal(
        PR.robust_demod_matrix(lo, hi, FS, ROBUST.oversample,
                               PR.LAM_PROFILES[1]),
        tables["m_stack"][2, 1].numpy())
    np.testing.assert_array_equal(PR.robust_templates(FS, ROBUST.oversample),
                                  tables["templates"].numpy())
    assert set(tables) == set(VERIFIER_TABLE_DTYPES)


# ------------------------------------------------- the verify cases, paired
def test_v2_loud_host_roundtrip(vers, wm_loud_host):
    r = both_verify(vers, wm_loud_host)
    assert r.authentic and r.stage == "hard" and r.timescale is None


def test_v2_mp3_sim_roundtrip(vers, wm_loud_host):
    mp3 = jchannels.codec_sim(wm_loud_host[: int(3.5 * FS)], 128.0)
    assert both_verify(vers, mp3).authentic


def test_v2_silence_host(vers, key32):
    wm = PR.RobustEmbedder(key32, rng=np.random.default_rng(2)).process(
        np.zeros(4 * FS, np.float32))
    assert both_verify(vers, wm).authentic


def test_v2_wrong_key_rejected(wm_loud_host):
    """Wrong key: the whole ladder runs (scan included) and rejects."""
    r = both_verify(pair(BAD_KEY, list_size=8), wm_loud_host)
    assert not r.authentic and r.stage is None


def test_v2_short_clip_rejected(vers, wm_loud_host):
    r = both_verify(vers, wm_loud_host[: 2 * FS])
    assert not r.authentic and r.peaks is None


def test_v2_noise_only_rejected(vers, rng):
    noise = (0.1 * rng.standard_normal(4 * FS)).astype(np.float32)
    assert not both_verify(vers, noise).authentic


def test_v2_441khz_capture(vers, wm_loud_host):
    down = PR.resample_to(44_100, wm_loud_host, FS)
    assert both_verify(vers, down, fs=44_100).authentic


def test_v2_timescale_grid(vers, wm_loud_host, monkeypatch):
    """+5 % playback speed recovers through the caller's grid."""
    scaled = time_scale(wm_loud_host, 1.05)
    for v in vers:
        monkeypatch.setattr(v, "timescale_grid", (1.0, 0.9524))
    r = both_verify(vers, scaled)
    assert r.authentic and r.timescale is not None
    assert abs(r.timescale - 0.9524) < 1e-3


@pytest.mark.parametrize("factor,via_scan", [(1.031, True)])
def test_v2_timescale_unknown_factor(vers, wm_loud_host, factor, via_scan,
                                     monkeypatch):
    """No caller hint: 3.1 % fast recovers only through ``estimate_scale``
    (a small factor such as 1.0065 recovers from the unscaled clip's own
    peak spacing, without the scan)."""
    jv, pv = vers
    scans = []
    orig = PR.RobustVerifier.estimate_scale

    def spy(self, signal):
        scans.append(orig(self, signal))
        return scans[-1]

    monkeypatch.setattr(PR.RobustVerifier, "estimate_scale", spy)
    scaled = time_scale(wm_loud_host, factor)
    r = both_verify(vers, scaled)
    assert r.authentic and abs(r.timescale - 1.0 / factor) < 1e-3
    assert bool(scans) == via_scan
    if via_scan:
        assert scans == [0.97] == [jv.estimate_scale(scaled)]


def test_estimate_scale_gate_on_noise(vers, rng):
    jv, pv = vers
    noise = (0.1 * rng.standard_normal(4 * FS)).astype(np.float32)
    assert pv.estimate_scale(noise) == jv.estimate_scale(noise)
    assert pv._scan_bank is not None and pv._scan_bank.shape[0] == 124


# ---------------------------------------------------------------- the rules
def test_device_rule_params_and_table_dtype(key32, vers, monkeypatch):
    from echoseal_torch.core.params import RxParams

    assert PR.resolve_table_dtype(None) is PR.resolve_table_dtype("f32") \
        is torch.float32
    with pytest.raises(ValueError, match="float32"):
        PR.resolve_table_dtype("bf16")
    with pytest.raises(ValueError, match="float32"):
        PR.RobustVerifier(key32, table_dtype="bf16", device="cpu")
    tables = {k: v.numpy() for k, v in vers[1].tables.items()}
    pv = PR.RobustVerifier.from_tables(
        key32, tables, device="cpu",
        params=RxParams(list_size=4, timescale_grid=(1.0, 0.98)))
    assert pv._list_size == 4 and pv.timescale_grid == (1.0, 0.98)
    assert pv.fs_target == FS and vers[1]._list_size == 32
    assert vers[1].timescale_grid == (1.0,)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PR.RobustVerifier(key32)


def test_session_latch_rejects_another_session(vers, key32, wm_loud_host):
    jv, pv = vers
    assert both_verify(vers, wm_loud_host).authentic
    other = PR.RobustEmbedder(key32, rng=np.random.default_rng(9)).embed(
        np.zeros(4 * FS, np.float32), session_nonce=b"othersss")
    got, want = pv.verify(other, FS), jv.verify(other, FS)   # latch kept
    assert got is want is False
    assert both_verify(vers, other).authentic
