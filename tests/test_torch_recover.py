"""echoseal_torch v2 ingest and time-scale recovery vs echoseal_tpu's, CPU.

The cases are those of tests/test_pipeline.py, on the shapes it compiles
(B <= 4, rows of 2**18 samples or the 240 844-sample 44.1 kHz capture that
ingests to them, ``max_ctr`` 4096), with the TX randomness pinned: the
watermarked stream comes from the port's seeded ``RobustEmbedder`` and goes
to both packages, and both verifiers run on identical tables.

Held: scan scores within 1e-4 and the argmax factor exactly; the ingested
batch within 1e-5 of the JAX ingest and the converted lengths exactly;
verdicts row-identical; and, through a spy on ``_retry_scaled``, the retry
lattice keys tried per clip and round equal in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from echoseal_torch.convert import V2_TABLE_DTYPES, numpy_tables_of
from echoseal_torch.core.profiles import ROBUST
from echoseal_torch.models import pipeline as PP
from echoseal_torch.models import robust as probust
from echoseal_torch.utils import channels as pchannels
from echoseal_torch.utils.logging import tracing
from echoseal_tpu.models import pipeline as JPL
from echoseal_tpu.models import robust as jrobust
from echoseal_tpu.utils import channels as jchannels
from torch_port_util import two_torch_threads  # noqa: F401

FS = 48_000
T = int(3.5 * FS)
TPAD = 1 << 18
T_IN_44K = 240_844            # ceil(240844 * 160 / 147) == 2**18
MAX_CTR = 4096


@pytest.fixture(scope="module")
def both(key32):
    """The JAX verifier and the port's on identical tables."""
    jv = JPL.RobustBatchVerifier(key32, max_ctr=MAX_CTR)
    pv = PP.RobustBatchVerifier.from_tables(
        key32, numpy_tables_of(jv, V2_TABLE_DTYPES), device="cpu")
    return jv, pv


@pytest.fixture(scope="module")
def wm(key32):
    """3.5 s of a loud 700 Hz host watermarked by the seeded port TX."""
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(T) / FS)
            ).astype(np.float32)
    return probust.RobustEmbedder(
        key32, rng=np.random.default_rng(1)).process(host)


@pytest.fixture(scope="module")
def v2_batch(key32, wm):
    """4 v2 clips: clean loud-host, MP3-sim, silence+AWGN(+4dB), no wm."""
    wm_sil = probust.RobustEmbedder(
        key32, rng=np.random.default_rng(2)).process(np.zeros(T, np.float32))
    rms = float(np.sqrt(np.mean(wm_sil**2)))
    rng = np.random.default_rng(3)
    clips = np.zeros((4, TPAD), np.float32)
    clips[0, :T] = wm
    clips[1, :T] = jchannels.codec_sim(wm, 128.0)[:T]
    clips[2, :T] = wm_sil + rms * 10 ** (-4 / 20) * rng.standard_normal(
        T).astype(np.float32)
    clips[3, :T] = 0.05 * rng.standard_normal(T).astype(np.float32)
    return clips, np.full(4, T, dtype=np.int32)


def _rows(signals, width=TPAD):
    """Zero-padded (n, width) rows and their true lengths."""
    clips = np.zeros((len(signals), width), np.float32)
    nv = np.zeros(len(signals), np.int32)
    for i, y in enumerate(signals):
        L = min(y.size, width)
        clips[i, :L] = y[:L]
        nv[i] = L
    return clips, nv


def _spy_retries(monkeypatch):
    """Per package, the {clip: lattice key} map of every ``_retry_scaled``."""
    calls = {"jax": [], "port": []}

    def wrap(cls, name):
        orig = cls._retry_scaled

        def spy(self, clips, n_valid, factors, *a, **k):
            q = self.RETRY_UP if k.get("clips_dev") is not None else self.fs
            calls[name].append({int(i): int(round(q * f))
                                for i, f in factors.items()})
            return orig(self, clips, n_valid, factors, *a, **k)

        monkeypatch.setattr(cls, "_retry_scaled", spy)

    wrap(JPL.RobustBatchVerifier, "jax")
    wrap(PP.RobustBatchVerifier, "port")
    return calls


def _recover_both(both, clips, nv, monkeypatch, **kw):
    """``verify_batch_recover`` in both packages -> (verdicts, key rounds)."""
    jv, pv = both
    calls = _spy_retries(monkeypatch)
    v_j = jv.verify_batch_recover(clips, nv, **kw)
    v_p = pv.verify_batch_recover(clips, nv, **kw)
    assert v_p.dtype == bool and v_p.tolist() == v_j.tolist()
    assert calls["port"] == calls["jax"]
    return v_p, calls["port"]


# ------------------------------------------------------- scan and estimator
def test_constants_and_channels_equal_jax(wm):
    assert probust.SCALE_SCAN_GRID == jrobust.SCALE_SCAN_GRID
    assert probust.FINE_CHAIN_MIN == jrobust.FINE_CHAIN_MIN
    assert PP.RobustBatchVerifier.RETRY_UP == JPL.RobustBatchVerifier.RETRY_UP
    for f in (1.031, 0.953):
        np.testing.assert_array_equal(pchannels.time_scale(wm[:9000], f),
                                      jchannels.time_scale(wm[:9000], f))
    np.testing.assert_array_equal(
        pchannels.awgn(wm[:9000], 6.0, np.random.default_rng(8)),
        jchannels.awgn(wm[:9000], 6.0, np.random.default_rng(8)))
    np.testing.assert_array_equal(pchannels.awgn(wm[:900], 3.0),
                                  jchannels.awgn(wm[:900], 3.0))


def test_scaled_template_bank_matches_jax():
    S = ROBUST.oversample
    got, want = (m.scaled_template_bank(FS, S) for m in (probust, jrobust))
    assert got.shape == want.shape == (31 * 4, want.shape[1])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    sub = (0.97, 1.0, 1.031)
    np.testing.assert_allclose(probust.scaled_template_bank(FS, S, sub),
                               jrobust.scaled_template_bank(FS, S, sub),
                               rtol=0, atol=1e-6)


def test_scale_scan_scores_and_argmax_match_jax(wm):
    """Scores within 1e-4; the winning factor of each clip exactly."""
    Ts = 1 << 16
    sig = [pchannels.time_scale(wm, f)[20_000:20_000 + 60_000]
           for f in (1.031, 0.978, 1.0)]
    sig.append((0.05 * np.random.default_rng(4).standard_normal(50_000)
                ).astype(np.float32))
    x, nv = _rows(sig, Ts)
    bank = probust.scaled_template_bank(FS, ROBUST.oversample)
    want = np.asarray(jrobust._scale_scan_batch(
        jnp.asarray(x), jnp.asarray(nv), jnp.asarray(bank)))
    got = probust._scale_scan_batch(
        torch.from_numpy(x), torch.from_numpy(nv), torch.from_numpy(bank))
    assert got.shape == (4, 124) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    grid = np.asarray(probust.SCALE_SCAN_GRID)

    def pick(s):
        return grid[s.reshape(4, 31, 4).max(-1).argmax(-1)]
    np.testing.assert_array_equal(pick(got.numpy()), pick(want))
    assert pick(got.numpy())[:3].tolist() == [0.97, 1.02333, 1.0]
    # another row chunking and the one-clip form give the same scores
    got3 = probust._scale_scan_batch(
        torch.from_numpy(x), torch.from_numpy(nv), torch.from_numpy(bank),
        row_chunk=7)
    np.testing.assert_allclose(got3.numpy(), got.numpy(), rtol=0, atol=1e-6)
    one = probust._scale_scan_stage(torch.from_numpy(x[1]), int(nv[1]),
                                    torch.from_numpy(bank))
    np.testing.assert_allclose(one.numpy(), got[1].numpy(), rtol=0, atol=1e-6)
    j_one = np.asarray(jrobust._scale_scan_stage(
        jnp.asarray(x[1]), jnp.asarray(nv[1]), jnp.asarray(bank)))
    np.testing.assert_allclose(one.numpy(), j_one, rtol=0, atol=1e-4)


def test_estimate_timescale_from_peaks_equals_jax():
    span = ROBUST.span
    rng = np.random.default_rng(5)
    cases = [None, np.full((4, 4), -1)]
    for resid in (1.0, 1.00007, 0.9991, 1.03, 1.08):
        ctr = np.sort(rng.choice(40, (4, 4), replace=False), axis=1)
        pk = np.rint(ctr * span / resid + rng.integers(-2, 3, (4, 4))
                     ).astype(np.int64)
        pk[rng.random((4, 4)) < 0.25] = -1
        cases.append(pk)
    cases.append(np.array([[100, 100 + span, -1, -1]] + [[-1] * 4] * 3))
    got = [probust.estimate_timescale_from_peaks(c, span) for c in cases]
    want = [jrobust.estimate_timescale_from_peaks(c, span) for c in cases]
    assert got == want
    assert got[0] is None and got[1] is None and got[-1] is None
    assert any(g is not None for g in got)


# ------------------------------------------------------------------ ingest
def test_v2_batch_ingest_44k1(both, v2_batch):
    """``verify_batch(fs_in=44100)``: the ingested batch equals the JAX
    ingest, and verdicts equal JAX's and the host-resample path's."""
    jv, pv = both
    clips, nv = v2_batch
    cap = resample_poly(clips.astype(np.float64), 147, 160,
                        axis=-1)[:, :T_IN_44K].astype(np.float32)
    nv44 = (nv.astype(np.int64) * 147 // 160).astype(np.int32)

    y_p, nv_p = pv._ingest(cap, nv44, 44_100)
    y_j, nv_j = jv._ingest(cap, nv44, 44_100)
    y_j = np.asarray(y_j)
    np.testing.assert_array_equal(nv_p, nv_j)
    assert nv_p.dtype == np.int32 and y_p.shape[1] >= TPAD
    assert np.abs(y_p[:, :TPAD].numpy() - y_j[:, :TPAD]).max() \
        <= 1e-5 * np.abs(y_j).max()
    assert float(y_p[:, TPAD:].abs().max()) == 0.0

    dev = pv.verify_batch(cap, nv44, fs_in=44_100)
    assert dev.tolist() == jv.verify_batch(cap, nv44, fs_in=44_100).tolist()
    back = np.stack([probust.resample_to(FS, row, 44_100) for row in cap])
    ref_clips, _ = _rows(list(back))
    ref = pv.verify_batch(
        ref_clips, np.minimum(nv44.astype(np.int64) * 160 // 147,
                              back.shape[1]).astype(np.int32))
    assert dev.tolist() == ref.tolist()
    assert bool(dev[0]) and not bool(dev[3])
    # the same capture read as 48 kHz is 8.8 % slow: nothing verifies
    assert not pv.verify_batch(cap, nv44).any()
    # fs_in equal to the verifier's rate is the plain call, tensors allowed
    same = pv.verify_batch(torch.from_numpy(clips[:1]),
                           torch.from_numpy(nv[:1]), fs_in=FS)
    assert same.tolist() == [True]


def test_v2_batch_ingest_96k_decimation(both, v2_batch):
    """Decimating ingest (96 kHz capture) through the scaled lattice."""
    jv, pv = both
    clips, nv = v2_batch
    cap = resample_poly(clips.astype(np.float64), 2, 1,
                        axis=-1).astype(np.float32)       # (4, 2 * 2**18)
    nv96 = nv.astype(np.int64) * 2
    dev = pv.verify_batch(cap, nv96, fs_in=96_000)
    assert bool(dev[0]) and not bool(dev[3])
    assert dev.tolist() == jv.verify_batch(cap, nv96, fs_in=96_000).tolist()
    fam = [k for k in pv._resamplers if k[3] == cap.shape[1]]
    assert fam == [(128, 256, 256, cap.shape[1])]         # 1/2 scaled by 128


# ---------------------------------------------------------------- recovery
def test_robust_batch_timescale_recovery(both, wm, monkeypatch):
    """+-5 % playback-speed recovery with no caller hint, off the scan grid."""
    jv, pv = both
    clips, nv = _rows([pchannels.time_scale(wm, f) for f in (1.031, 0.978)])
    assert not pv.verify_batch(clips, nv).any()         # hidden without it
    with tracing() as tr:
        v, rounds = _recover_both(both, clips, nv, monkeypatch)
    assert v.all()
    assert rounds[0] == {0: 11640, 1: 12280}            # the scan's picks
    spans = tr.drain()
    assert any(s["name"] == "recover.first_pass" for s in spans)
    (scan,) = [s for s in spans if s["name"] == "recover.scan"]
    assert scan["attrs"]["rows"] == 2
    log = pv.recover_log
    assert log["scan_rows"] == 2
    assert log["rounds"][0]["rows"] == 2 and log["rounds"][0]["host_rows"] == 0
    assert log["rounds"][0]["dens"] == [11640, 12280]
    assert (12_000, 10_510, 13_642, TPAD) in pv._resamplers


def test_recover_reciprocal_fallback_rescues_wrong_basin(both, wm,
                                                         monkeypatch):
    """A scan that argmaxes the RECIPROCAL basin must still recover."""
    wrong_i = probust.SCALE_SCAN_GRID.index(0.97)   # reciprocal of true 1.031

    def wrong_basin_scan(x, nv, bank):
        s = np.zeros((x.shape[0], bank.shape[0]), np.float32)
        s[:, 4 * wrong_i: 4 * wrong_i + 4] = 1.0
        return s

    monkeypatch.setattr(probust, "_scale_scan_batch", wrong_basin_scan)
    monkeypatch.setattr(jrobust, "_scale_scan_batch", wrong_basin_scan)
    y = pchannels.time_scale(wm, 1.0 / 1.031)
    clips, nv = _rows([y, y])
    v, rounds = _recover_both(both, clips, nv, monkeypatch)
    assert v.all()
    assert rounds[0] == {0: 11640, 1: 11640}
    assert any(12_000 < k for r in rounds[1:] for k in r.values())


def _stub_always_fail(bv, monkeypatch, zeros, ones):
    """Stub the stage and the ladder so that every retry fails."""
    def fake_run_device(batch, nv2):
        B = int(batch.shape[0])
        return {"peak_val": ones((B, 4, bv.peaks)),
                "peak_idx": zeros((B, 4, bv.peaks))}

    monkeypatch.setattr(bv, "run_device", fake_run_device)
    monkeypatch.setattr(bv, "_finish_ladder",
                        lambda *a, **k: np.zeros(1, bool))


def test_refine_chains_sub_1e4_lattice_residual(key32, both, monkeypatch):
    """A spacing estimate inside 1e-4 must chain to the adjacent lattice
    point (11640 -> 11639), not abstain; both packages walk alike."""
    jv, pv = both
    Tp = 1 << 17
    clips = np.zeros((1, Tp), np.float32)
    nv = np.full(1, Tp, np.int32)
    for mod in (probust, jrobust):
        monkeypatch.setattr(mod, "estimate_timescale_from_peaks",
                            lambda peaks, span: 1.0 - 7.0e-5)
    _stub_always_fail(pv, monkeypatch,
                      lambda s: torch.zeros(s, dtype=torch.int32), torch.ones)
    _stub_always_fail(jv, monkeypatch,
                      lambda s: jnp.zeros(s, jnp.int32), jnp.ones)
    calls = _spy_retries(monkeypatch)
    tried = {}
    pv._retry_scaled(clips, nv, {0: 0.97}, np.zeros(1, bool), None,
                     refine=2, clips_dev=torch.from_numpy(clips), nv_dev=nv,
                     tried=tried)
    jv._retry_scaled(clips, nv, {0: 0.97}, np.zeros(1, bool), None,
                     refine=2, clips_dev=jnp.asarray(clips), nv_dev=nv)
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] == {0: 11640}
    assert calls["port"][1] == {0: 11639}
    assert tried == {0: {k[0] for k in calls["port"] if k}}


def test_recover_accepts_device_resident_clips(both, wm, monkeypatch):
    """A ``torch.Tensor`` batch gives the verdicts of the numpy batch; host
    bytes are materialised only by an out-of-family factor."""
    jv, pv = both
    clips, nv = _rows([pchannels.time_scale(wm, 1.031), wm])
    calls = _spy_retries(monkeypatch)
    dev = torch.from_numpy(clips)
    v_dev = pv.verify_batch_recover(dev, torch.from_numpy(nv))
    n_dev = len(calls["port"])
    v_np = pv.verify_batch_recover(clips, nv)
    assert v_dev.tolist() == v_np.tolist() == [True, True]
    assert calls["port"][:n_dev] == calls["port"][n_dev:]
    assert all(1 not in r for r in calls["port"])   # row 1 never retried
    v_j = jv.verify_batch_recover(jax.device_put(jnp.asarray(clips)), nv)
    assert v_j.tolist() == v_dev.tolist()
    assert calls["jax"] == calls["port"][:n_dev]

    # lazy host materialisation: out-of-family factor, clips passed None
    n_rounds = len(pv.recover_log["rounds"])
    out = pv._retry_scaled(None, nv, {0: 1.2}, np.zeros(2, bool), None,
                           refine=0, clips_dev=dev, nv_dev=nv, fs_host=FS)
    assert out.dtype == bool and not out[0]     # junk factor cannot accept
    assert pv.recover_log["rounds"][n_rounds]["host_rows"] == 1


def test_recover_composes_with_fs_in_ingest(both, wm, monkeypatch):
    """``verify_batch_recover(fs_in=44100)``: ingest + speed recovery."""
    jv, pv = both
    cap = [resample_poly(pchannels.time_scale(wm, f).astype(np.float64),
                         147, 160).astype(np.float32)
           for f in (1.031, 0.978)]             # wrong speed, 44.1 kHz capture
    clips, nv = _rows(cap, T_IN_44K)
    assert not pv.verify_batch(clips, nv, fs_in=44_100).any()
    v, rounds = _recover_both(both, clips, nv, monkeypatch, fs_in=44_100)
    assert v.all() and rounds[0] == {0: 11640, 1: 12280}


def test_device_resident_fs_in_host_fallback_rate(both, wm):
    """The out-of-family host path on a device-resident ``fs_in`` batch
    corrects on the ingested 48 kHz timeline (exact rational 6/5, past
    every factor the retry rounds reach on the device)."""
    jv, pv = both
    y = resample_poly(wm.astype(np.float64), 6, 5).astype(np.float32)
    cap = resample_poly(y.astype(np.float64), 147, 160).astype(np.float32)
    clips, nv = _rows([cap, cap], T_IN_44K)
    clips48, nv48 = pv._ingest(torch.from_numpy(clips), nv, 44_100)
    out = pv._retry_scaled(None, nv, {0: 1.2}, np.zeros(2, bool), None,
                           refine=0, clips_dev=clips48, nv_dev=nv48,
                           fs_host=44_100)
    assert out[0], "host fallback must correct on the ingested timeline"
    assert pv.recover_log["rounds"][-1]["host_rows"] == 1
    j48, jnv48 = jv._ingest(jnp.asarray(clips), nv, 44_100)
    j_out = jv._retry_scaled(None, nv, {0: 1.2}, np.zeros(2, bool), None,
                             refine=0, clips_dev=j48,
                             nv_dev=np.asarray(jnv48, np.int32),
                             fs_host=44_100)
    assert j_out.tolist() == out.tolist()


def test_mixed_round_device_and_host_rows(both, wm, monkeypatch):
    """One round with a row resampled on the device (0.97, in the family)
    and one on the host (6/5, past it): one stage re-verifies both, the
    device group ahead of the host group, each accept at its factor."""
    _, pv = both
    slow = resample_poly(wm.astype(np.float64), 6, 5).astype(np.float32)
    clips, nv = _rows([pchannels.time_scale(wm, 1.031), slow])
    runs = []
    run = pv.run_device
    monkeypatch.setattr(pv, "run_device",
                        lambda *a, **k: runs.append(1) or run(*a, **k))
    details = {}
    out = pv._retry_scaled(None, nv, {0: 0.97, 1: 1.2}, np.zeros(2, bool),
                           None, refine=0, clips_dev=torch.from_numpy(clips),
                           nv_dev=nv, fs_host=FS, details=details)
    assert len(runs) == 1
    last = pv.recover_log["rounds"][-1]
    assert last["clips"] == [0, 1] and last["keys"] == [11640, 14400]
    assert last["host_rows"] == 1 and last["rows"] == 2
    assert out.tolist() == [True, True]
    assert {i: d.factor for i, d in details.items()} == {0: 0.97, 1: 1.2}


def test_retry_identity_lattice_guard(both, v2_batch):
    """Retry factors that quantize to the lattice identity are skipped."""
    jv, pv = both
    clips, nv = v2_batch
    n_rounds = len(pv.recover_log["rounds"])
    out = pv._retry_scaled(None, nv, {3: 1.0, 2: 1.00003}, np.zeros(4, bool),
                           None, refine=0, clips_dev=torch.from_numpy(clips),
                           nv_dev=nv, fs_host=FS)
    assert not out.any()
    assert len(pv.recover_log["rounds"]) == n_rounds    # nothing dispatched
    j_out = jv._retry_scaled(None, nv, {3: 1.0, 2: 1.00003}, np.zeros(4, bool),
                             None, refine=0,
                             clips_dev=jax.device_put(jnp.asarray(clips)),
                             nv_dev=nv, fs_host=FS)
    assert not j_out.any()


def test_recover_defers_escalation_for_unscaled_clips(both, v2_batch,
                                                      monkeypatch):
    """With no scaled clip, recovery equals ``verify_batch``: the SCL-only
    rows are rescued by the deferred escalation, the noise row stays out."""
    _, pv = both
    clips, nv = v2_batch
    seen = []
    orig = PP.RobustBatchVerifier._scl_fallback

    def spy(self, out, pending, expected_nonce, details=None):
        seen.append(pending.copy())
        return orig(self, out, pending, expected_nonce, details=details)

    monkeypatch.setattr(PP.RobustBatchVerifier, "_scl_fallback", spy)
    v, _ = _recover_both(both, clips, nv, monkeypatch)
    assert v.tolist() == [True, True, True, False]
    assert v.tolist() == pv.verify_batch(clips, nv).tolist()
    assert seen and all(not p[3] for p in seen)


def test_recover_expected_nonce_and_all_pass_shortcut(both, wm):
    """A batch that passes the hard pass returns before the scan; the
    anti-replay hook reaches the retry re-verify."""
    _, pv = both
    clips, nv = _rows([wm])
    with tracing() as tr:
        assert pv.verify_batch_recover(clips, nv).tolist() == [True]
    names = [s["name"] for s in tr.drain()]
    assert "recover.first_pass" in names
    assert "recover.scan" not in names and "recover.deferred" not in names
    log = pv.recover_log
    assert log["rounds"] == [] and log["scan_rows"] == 0
    scaled, nvs = _rows([pchannels.time_scale(wm, 0.978)])
    assert not pv.verify_batch_recover(
        scaled, nvs, expected_nonce=b"another!").any()
    assert pv.recover_log["rounds"]


def test_fallback_queue_starves_lattice_neighbour_in_both(key32, both,
                                                          monkeypatch):
    """A loss the port shares with the JAX package (ROADMAP Queue C4).

    This clip, played 3.1 % fast, decodes at 11639/12000 but not at the
    scan's pick 11640/12000 and shows no peak spacing to chain from.  Both
    packages then spend the four refinement rounds on the fallback queue
    and its chains (the reciprocal basin 12371, then 12270, 12251, 11720),
    so the lattice-neighbour last resort never runs and the clip is lost.
    The port keeps the rule: its verdicts stay row-identical.
    """
    _, pv = both
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(5 * FS) / FS)
            ).astype(np.float32)
    stream = probust.RobustEmbedder(
        key32, rng=np.random.default_rng(1)).process(host)
    starts = np.random.default_rng(5).integers(0, stream.size - T, 8)
    clips, nv = _rows([pchannels.time_scale(stream[s:s + T], 1.031)
                       for s in starts[[6, 0]]])
    v, rounds = _recover_both(both, clips, nv, monkeypatch)
    assert v.tolist() == [False, True]
    assert rounds[0] == {0: 11640, 1: 11640}
    assert [r[0] for r in rounds[1:]] == [12371, 12270, 12251, 11720]
    rescued = pv._retry_scaled(
        clips, nv, {0: 11639 / 12_000}, np.zeros(2, bool), None, refine=0,
        clips_dev=torch.from_numpy(clips), nv_dev=nv)
    assert rescued.tolist() == [True, False]


def test_speech_host_recovery_matches_jax(key32, both, monkeypatch):
    """Four seeded speech-host cuts played 3.1 % fast: the verdicts of
    ``verify_batch_recover`` and the lattice keys tried in every round are
    row-identical to the JAX package's (ROADMAP Queue C, speech-host
    recovery: the port's 0.719 on the card against the TPU row's 0.157 is
    not a port fault)."""
    host = pchannels.speech_host(12.0, FS, rng=np.random.default_rng(77))
    tx = probust.RobustEmbedder(key32, rng=np.random.default_rng(11))
    stream = np.concatenate([tx.process(host[i:i + 1024])
                             for i in range(0, host.size, 1024)])
    starts = np.random.default_rng(12).integers(0, stream.size - T, 4)
    clips, nv = _rows([pchannels.time_scale(stream[s:s + T], 1.031)
                       for s in starts])
    assert not both[1].verify_batch(clips, nv, use_scl=False).any()
    v, rounds = _recover_both(both, clips, nv, monkeypatch)
    assert rounds[0] == {0: 11640, 1: 11640, 2: 11640, 3: 11640}
    assert v.any()          # some clips come back, in both packages alike
