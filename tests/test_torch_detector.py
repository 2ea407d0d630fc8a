"""echoseal_torch single-clip compat verify vs echoseal_tpu's, on the CPU.

The same seeded clips (TX through the port's seeded embedders, which equal
the JAX ones) and the same tables go through ``WatermarkDetector`` of both
packages.

What is held, and why:

* Host designs are bit-equal; ``cfar_threshold`` follows ``jnp.median``
  (mean of the two middle values of an even-length row) within 1e-6.
* ``_scan_stage``: threshold and peak scores within 1e-4; peak positions,
  validity and the aligned candidates' direct-model header reads (both
  profiles) exact; their preamble scores within 1e-4 for the refined and
  the cascade profile.  The cascade model's chips are poor on a silence
  host (preamble score ~0.1), so a marginal header bit of its reads tips
  with the number of threads the products run on: ``hdr_ok_c`` must agree
  on 95 % of the candidates and ``hdr_lo16_c`` on 95 % of those both
  packages call readable.  The raw profile's preamble score and the header scores are
  ratios of raw chip sums, so they move with the chips (next point): held
  within 5e-3 relative (measured: 3.3e-4 and 1.4e-3).  Only the aligned
  offset (0) is held for the per-candidate keys: at +-1 and +-2 samples
  the exact inversion returns noise, which differs between any two
  float32 implementations (32 of 1000 such header reads differ).
* Chips come from the lam=1e-12 inversion (condition number ~1e5), so they
  are held by accuracy (ROADMAP C1): the port's distance from a float64 run
  of the same stage is at most 1.25 x the JAX package's.
* ``_llr_stage`` on the JAX stage's chips: ``info`` and ``crc_ok`` exact,
  ``llr`` within 1e-4.
* ``VerifyResult`` fields (``authentic``, ``frame_ctr``, ``band``,
  ``peak_pos``, ``stage``, ``session_nonce``) are equal on every case of
  tests/test_detector.py.  Which frame accepts first can differ when a
  frame's hard decode is marginal (C1): of twelve seeded 4 s streams one
  (seed 3) has the JAX package accept frame 0 on its first try and the
  port frame 11 on its fifth.  The paired cases use streams on which both
  accept the same candidate; seed 3 is kept as a case of its own, held to
  what does hold there.  Which way a marginal decode tips also moves with
  the number of threads torch runs its products on, so the frame fields
  are held equal only when both packages accepted on the same try; on
  different tries each counter must match its own peak position.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echoseal_torch.convert import DETECTOR_TABLE_DTYPES, numpy_tables_of
from echoseal_torch.core.params import FRAME_LEN, HDR_L, N_DEFAULT, PRE_L
from echoseal_torch.models import detector as PD
from echoseal_torch.models.embedder import BatchEmbedder, WatermarkEmbedder
from echoseal_torch.ops import demod as P
from echoseal_tpu.models import detector as JD
from echoseal_tpu.ops import demod as J
from torch_port_util import compat_stream, two_torch_threads  # noqa: F401

FS = 48_000
TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = ("authentic", "frame_ctr", "band", "peak_pos", "stage",
          "session_nonce")
FRAME_FIELDS = ("frame_ctr", "band", "peak_pos")
BAD_KEY = bytes.fromhex("bb" * 32)
O0 = PD.N_OFFSETS // 2          # the aligned offset within a peak's five


def pair(key, list_size=8):
    """The JAX detector and the port's on identical tables."""
    jd = JD.WatermarkDetector(key, list_size=list_size)
    pd = PD.WatermarkDetector.from_tables(
        key, numpy_tables_of(jd, DETECTOR_TABLE_DTYPES), device="cpu",
        list_size=list_size)
    return jd, pd


@pytest.fixture(scope="module")
def dets(key32):
    return pair(key32)


@pytest.fixture(scope="module")
def bad_dets():
    return pair(BAD_KEY)


@pytest.fixture(scope="module")
def wm_silence(key32):
    return compat_stream(key32, 4, seed=1)


def assert_same_result(rp, rj, hop, offset=0):
    """The port's ``VerifyResult`` against the JAX package's.

    Verdict, stage and session nonce are equal.  So is the accepted frame
    (counter, band, peak position) whenever both accepted on the same try.
    On different tries a marginal candidate's decode tipped (C1); then
    each side's counter must be the one its peak position implies, for a
    clip cut ``offset`` samples into a stream that starts at frame 0.
    """
    for f in ("authentic", "stage", "session_nonce"):
        assert getattr(rp, f) == getattr(rj, f), (f, rp, rj)
    if rp.tries == rj.tries:
        for f in FRAME_FIELDS:
            assert getattr(rp, f) == getattr(rj, f), (f, rp, rj)
    else:
        for r in (rp, rj):
            assert abs(r.frame_ctr * FRAME_LEN - (offset + r.peak_pos)) <= 2, r
            assert r.band == hop.band(r.frame_ctr), r


def both_verify(dets, audio, fs=FS, fresh=True, offset=0):
    """``verify_detailed`` of both packages, held by ``assert_same_result``."""
    jd, pd = dets
    if fresh:
        jd.session_nonce = pd.session_nonce = None
    rj, rp = jd.verify_detailed(audio, fs), pd.verify_detailed(audio, fs)
    assert_same_result(rp, rj, pd._hop, offset)
    assert pd.session_nonce == jd.session_nonce
    return rp


# ------------------------------------------------------------ host designs
def test_all_demod_matrices_bit_equal(key32, dets):
    md, mc = P.all_demod_matrices(FS)
    jmd, jmc = J.all_demod_matrices(FS)
    assert md.shape == (4, 2, 1215, 1215) and mc.shape == (4, 1, 1215, 1727)
    np.testing.assert_array_equal(md, jmd)
    np.testing.assert_array_equal(mc, jmc)
    assert (P.CASCADE_TAIL, P.W_CASCADE, P.LAM_DIRECT_PROFILES,
            P.LAM_CASCADE) == (J.CASCADE_TAIL, J.W_CASCADE,
                               J.LAM_DIRECT_PROFILES, J.LAM_CASCADE)
    # the port's own constructor designs the tables the JAX detector holds
    own = PD.host_tables(dets[1].sec, FS)
    for k in DETECTOR_TABLE_DTYPES:
        np.testing.assert_array_equal(own[k], dets[1].tables[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("n", [1000, 1001, 131010])
def test_cfar_threshold_follows_jnp_median(rng, n):
    x = (0.1 * rng.standard_normal((4, n))).astype(np.float32)
    x[1, : n // 2] = 0.0                 # a row that is half padding
    x[2] += 0.9                          # a row that hits the 0.95 cap
    got = P.cfar_threshold(torch.from_numpy(x)).numpy()
    want = np.asarray(J.cfar_threshold(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert want[2] == np.float32(0.95)


def test_gather_windows_clips_starts(rng):
    x = rng.standard_normal(400).astype(np.float32)
    starts = np.array([-2, -1, 0, 57, 390, 399], np.int32)
    got = P.gather_windows(torch.from_numpy(x), torch.from_numpy(starts), 16)
    want = np.asarray(J.gather_windows(jnp.asarray(x), jnp.asarray(starts), 16))
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------- the stages
@pytest.fixture(scope="module")
def scans(dets, key32):
    """Both packages' ``_scan_stage`` on one 3.5 s mid-stream silence clip."""
    jd, pd = dets
    clip = compat_stream(key32, 8, seed=2)[3 * FS + 517:][: int(3.5 * FS)]
    Tpad = PD._pad_bucket(clip.size)
    assert Tpad == JD._pad_bucket(clip.size) == 1 << 18
    x = np.zeros(Tpad, np.float32)
    x[: clip.size] = clip
    jo = JD._scan_stage(jnp.asarray(x), jnp.int32(clip.size), jd._templates,
                        jd._fir_bank, jd._m_direct, jd._m_cascade, jd._t_fwd,
                        jd._pre_sy, jd._hdr_pn_sy)
    po = PD._scan_stage(torch.from_numpy(x), clip.size, pd.tables)
    return (x, clip.size, {k: np.asarray(v) for k, v in jo.items()},
            {k: v.numpy() for k, v in po.items()})


def test_scan_stage_sync_outputs_match(scans):
    _, _, jo, po = scans
    np.testing.assert_allclose(po["corr_thr"], jo["corr_thr"], **TOL)
    np.testing.assert_array_equal(po["peak_idx"], jo["peak_idx"])
    np.testing.assert_array_equal(po["peak_valid"], jo["peak_valid"])
    np.testing.assert_allclose(po["peak_val"], jo["peak_val"], **TOL)
    assert jo["peak_valid"].sum() >= 60          # real frames in every band


def test_scan_stage_aligned_candidates_match(scans):
    """Header reads and preamble scores at each valid peak's offset 0."""
    _, _, jo, po = scans
    valid = jo["peak_valid"]                     # (4, K)
    def aligned(o, k, p):
        return o[k][:, p, O0::PD.N_OFFSETS][valid]

    for k in ("hdr_ok_d", "hdr_lo16_d", "hdr_ok_c", "hdr_lo16_c"):
        assert po[k].shape == jo[k].shape
    for k in ("hdr_ok_d", "hdr_lo16_d"):
        for p in range(jo[k].shape[1]):
            np.testing.assert_array_equal(aligned(po, k, p),
                                          aligned(jo, k, p), err_msg=k)
    ok_p, ok_j = aligned(po, "hdr_ok_c", 0), aligned(jo, "hdr_ok_c", 0)
    assert np.mean(ok_p == ok_j) >= 0.95
    both = ok_p & ok_j
    assert np.mean(aligned(po, "hdr_lo16_c", 0)[both]
                   == aligned(jo, "hdr_lo16_c", 0)[both]) >= 0.95
    for k, p, tol in (("pre_d", 0, TOL), ("pre_c", 0, TOL),
                      ("pre_d", 1, dict(rtol=5e-3)),
                      ("hdr_score_d", 0, dict(rtol=5e-3)),
                      ("hdr_score_d", 1, dict(rtol=5e-3)),
                      ("hdr_score_c", 0, dict(rtol=5e-3))):
        np.testing.assert_allclose(aligned(po, k, p), aligned(jo, k, p),
                                   err_msg=f"{k}[{p}]", **tol)
    assert jo["hdr_ok_d"][:, 0, O0::PD.N_OFFSETS][valid].all()
    assert po["chips_d"].shape == jo["chips_d"].shape == (4, 2, 125, 1215)
    assert po["chips_c"].shape == jo["chips_c"].shape == (4, 1, 125, 1215)


def test_scan_stage_chips_as_accurate_as_jax(dets, scans):
    """Port and JAX chips stand equally close to a float64 run (C1)."""
    x, n, jo, po = scans
    t64 = {k: v.double() for k, v in dets[1].tables.items()}
    ref = PD._scan_stage(torch.from_numpy(x).double(), n, t64)
    np.testing.assert_array_equal(ref["peak_idx"].numpy(), jo["peak_idx"])
    valid = jo["peak_valid"]
    amp = None
    for k in ("chips_d", "chips_c"):
        r = ref[k].numpy()[:, :, O0::PD.N_OFFSETS]          # (4, P, K, 1215)
        ej, ep = (np.abs(o[k][:, :, O0::PD.N_OFFSETS] - r).max(-1)
                  for o in (jo, po))
        for p in range(r.shape[1]):
            err_j = np.median(ej[:, p][valid])
            err_p = np.median(ep[:, p][valid])
            amp = np.median(np.abs(r[:, p][valid]))
            assert err_p <= 1.25 * err_j and err_j < 0.05 * amp, \
                (k, p, err_p, err_j, amp)
    agree = np.mean(np.sign(po["chips_d"][:, 0, O0::PD.N_OFFSETS][valid])
                    == np.sign(jo["chips_d"][:, 0, O0::PD.N_OFFSETS][valid]))
    assert agree > 0.995, agree


def test_llr_stage_on_jax_chips(dets, scans):
    """Despread + hard decode of the JAX stage's chips, right PN and wrong."""
    jd, pd = dets
    _, _, jo, _ = scans
    band0 = jd._hop.index(0)
    ks = np.flatnonzero(jo["peak_valid"][band0])[:12]
    chips = np.concatenate([jo["chips_d"][band0, 0, ks * PD.N_OFFSETS + O0],
                            jo["chips_c"][band0, 0, ks * PD.N_OFFSETS + O0]])
    lo16 = jo["hdr_lo16_d"][band0, 0, ks * PD.N_OFFSETS + O0]
    ctrs = np.concatenate([lo16, lo16 + 1])      # the cascade rows: wrong PN
    pn = pd.sec.pn_bits_batch(ctrs, FRAME_LEN)[:, PRE_L + HDR_L:]
    pn_sy = 2.0 * pn.astype(np.float32) - 1.0
    assert pn_sy.shape == (24, N_DEFAULT)
    j_llr, j_info, j_crc = (np.asarray(a) for a in JD._llr_stage(
        jnp.asarray(chips), jnp.asarray(pn_sy)))
    p_llr, p_info, p_crc = (a.numpy() for a in PD._llr_stage(
        torch.from_numpy(chips), torch.from_numpy(pn_sy)))
    np.testing.assert_allclose(p_llr, j_llr, **TOL)
    np.testing.assert_array_equal(p_info, j_info)
    np.testing.assert_array_equal(p_crc, j_crc)
    assert j_crc[:12].sum() >= 6 and not j_crc[12:].any()


# ------------------------------------------------- the verify cases, paired
def test_roundtrip_silence_host(dets, wm_silence):
    r = both_verify(dets, wm_silence)
    assert r.authentic and r.stage == "hard" and r.frame_ctr is not None


def test_roundtrip_repeat_same_session(dets, wm_silence):
    assert both_verify(dets, wm_silence).authentic
    # same session nonce verifies again (anti-replay latch accepts repeats)
    assert both_verify(dets, wm_silence, fresh=False).authentic


def test_antireplay_different_session(dets, key32, wm_silence):
    assert both_verify(dets, wm_silence).authentic
    wm2 = compat_stream(key32, 4, seed=4)           # another session nonce
    assert not both_verify(dets, wm2, fresh=False).authentic
    assert both_verify(dets, wm2).authentic       # a fresh latch accepts it


def test_marginal_first_frame_accepts_another_frame(dets, key32):
    """Seed 3: frame 0's hard decode is marginal, so the packages may accept
    different frames; verdict, stage and session agree, and each accepted
    counter is the one its peak position implies."""
    jd, pd = dets
    wm = compat_stream(key32, 4, seed=3)
    jd.session_nonce = pd.session_nonce = None
    rj, rp = jd.verify_detailed(wm, FS), pd.verify_detailed(wm, FS)
    assert rj.authentic and rp.authentic
    assert rp.stage == rj.stage == "hard"
    assert rp.session_nonce == rj.session_nonce == pd.session_nonce
    for r in (rj, rp):
        assert r.frame_ctr == round(r.peak_pos / FRAME_LEN)
        assert r.band == pd._hop.band(r.frame_ctr)


def test_wrong_key_rejected(bad_dets, wm_silence):
    assert not both_verify(bad_dets, wm_silence).authentic


def test_plain_noise_rejected(dets, rng):
    noise = (0.1 * rng.standard_normal(4 * FS)).astype(np.float32)
    assert not both_verify(dets, noise).authentic


def test_lowpass_strips_watermark(dets, wm_silence):
    from scipy.signal import butter, lfilter

    b, a = butter(8, 3500 / (FS / 2), "low")
    stripped = lfilter(b, a, wm_silence).astype(np.float32)
    assert not both_verify(dets, stripped).authentic


@pytest.mark.parametrize("n", [2 * FS, 0], ids=["short", "empty"])
def test_short_and_empty_clip_rejected(dets, wm_silence, n):
    r = both_verify(dets, wm_silence[:n])
    assert not r.authentic and r.stage is None


def test_mid_stream_clip(dets, key32):
    long_wm = compat_stream(key32, 8, seed=2)
    start = 3 * FS + 517          # unaligned offset, frames ctr ~118+
    r = both_verify(dets, long_wm[start:start + int(3.5 * FS)], offset=start)
    assert r.authentic and r.frame_ctr > 100


def test_441khz_resample_path(dets):
    noise = (0.01 * np.random.default_rng(0).standard_normal(
        int(3.5 * 44_100))).astype(np.float32)
    assert not both_verify(dets, noise, fs=44_100).authentic


@pytest.mark.parametrize("which", ["right_key", "wrong_key"])
def test_verify_raw_frame(dets, bad_dets, key32, which):
    frame = WatermarkEmbedder(
        key32, rng=np.random.default_rng(5))._make_frame_chips()
    jd, pd = dets if which == "right_key" else bad_dets
    jd.session_nonce = pd.session_nonce = None
    got, want = pd.verify_raw_frame(frame), jd.verify_raw_frame(frame)
    assert got is want is (which == "right_key")
    assert pd.verify_raw_frame(frame[:100]) is False


def test_batch_embedder_stream_verifies(dets, key32):
    be = BatchEmbedder(key32, device="cpu")
    wm = be.embed(np.zeros(4 * FS, np.float32), session_nonce=b"unittest",
                  rng=np.random.default_rng(6))
    r = both_verify(dets, wm)
    assert r.authentic and r.session_nonce == b"unittest"


def test_alternate_pn_convention_stream(dets, key32):
    """A whole stream spread with the PN restarted at the payload verifies
    through the variant-1 rung (``hard-alt`` / ``scl-alt``)."""
    from scipy.signal import lfilter

    from echoseal_torch.core.params import TxParams
    from echoseal_torch.core.sequences import bits_to_bpsk, header_bits
    from echoseal_torch.ops import filters
    from echoseal_torch.ops.polar import encode_np, polar_spec

    pd = dets[1]
    sec, hop, spec = pd.sec, pd._hop, polar_spec()
    rng = np.random.default_rng(7)
    pre_sy = bits_to_bpsk(TxParams().preamble)
    hdr_pn_sy = bits_to_bpsk(sec.pn_bits(0, HDR_L))
    frames = []
    for ctr in range(160):
        payload = sec.seal_many(
            [b"ESAL" + ctr.to_bytes(4, "big") + b"ALTPNPNA" + b"\x11" * 11],
            [rng.bytes(12)])[0]
        data_sy = bits_to_bpsk(encode_np(payload, spec))
        hdr_sy = bits_to_bpsk(header_bits(ctr)) * hdr_pn_sy
        pn_alt = bits_to_bpsk(sec.pn_bits(ctr, N_DEFAULT))
        lo, hi = hop.band(ctr)
        b, a = filters.butter_coeffs(lo, hi, FS)
        zi0 = np.zeros(max(len(a), len(b)) - 1, dtype=np.float64)
        y_pre, zi1 = lfilter(b, a, pre_sy, zi=zi0)
        y_rest, _ = lfilter(
            b, a, np.concatenate((hdr_sy, data_sy * pn_alt)), zi=zi1)
        frames.append(np.concatenate((y_pre, y_rest)).astype(np.float32))
    stream = np.concatenate(frames) * 0.0178
    r = both_verify(dets, stream)
    assert r.authentic and r.stage in ("hard-alt", "scl-alt")
    assert r.session_nonce == b"ALTPNPNA"


# ---------------------------------------------------------------- the rules
def test_device_rule_params_and_reexports(key32, monkeypatch):
    from echoseal_torch.core.params import RxParams

    assert PD.resample_to is __import__(
        "echoseal_torch.ops.resample", fromlist=["x"]).resample_to
    assert (PD.MIN_CLIP_SECONDS, PD.N_OFFSETS) == (JD.MIN_CLIP_SECONDS,
                                                   JD.N_OFFSETS)
    for n in (1, 1 << 17, (1 << 17) + 1, 200_000, 1 << 19):
        assert PD._pad_bucket(n) == JD._pad_bucket(n)
    torch.backends.cuda.matmul.allow_tf32 = True
    pd = PD.WatermarkDetector(key32, params=RxParams(list_size=4),
                              list_size=16, device="cpu")
    assert pd._list_size == 16 and pd.device.type == "cpu"
    assert pd.p.accept_legacy_plaintext is True
    assert torch.backends.cuda.matmul.allow_tf32 is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PD.WatermarkDetector(key32)


def test_legacy_plaintext_gate_and_latch(key32, dets):
    """``_accept``: legacy plaintext only when allowed; the nonce latches."""
    from echoseal_torch.core.params import RxParams

    jd, pd = dets
    plain = b"ESAL" + (7).to_bytes(4, "big") + b"sessionL" + bytes(39)
    bits = np.unpackbits(np.frombuffer(plain, np.uint8))
    for det in (jd, pd):
        det.session_nonce = None
        assert det._accept(bits, 7) == b"sessionL"
        assert det._accept(bits, 8) is None               # counter mismatch
        det.session_nonce = b"otherses"
        assert det._accept(bits, 7) is None               # latched elsewhere
        det.session_nonce = None
    strict = PD.WatermarkDetector.from_tables(
        key32, {k: v.numpy() for k, v in pd.tables.items()}, device="cpu",
        params=RxParams(accept_legacy_plaintext=False))
    assert strict._accept(bits, 7) is None
    sealed = np.unpackbits(np.frombuffer(
        pd.sec.seal(plain[:27]), np.uint8))
    assert strict._accept(sealed, 7) == b"sessionL"
