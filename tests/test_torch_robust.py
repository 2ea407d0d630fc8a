"""echoseal_torch v2 (robust) batch verify vs echoseal_tpu's, on the CPU.

Same clips (the tests/test_pipeline.py ``v2_batch`` corpus: clean loud host,
MP3-sim of it, silence host + AWGN at +4 dB, no watermark; 3.5 s in
2**18-sample rows, ``max_ctr`` 4096) and the same tables (read off the JAX
verifier with ``convert.numpy_tables_of``) go through both verifiers.

What is held, and why (ROADMAP Queue C3):

* Peak scores within 1e-4, rank by rank.  Peak positions are equal except
  where two lags tie: over 324 seeds of this corpus one entry differed
  (seed 230, float32 sync, MP3-sim clip, a band that holds no frame:
  lags 38902 and 38905 score 4.65395e-4 and differ by 5e-10 in the JAX
  package and by -1.7e-9 in the port, so each package's argmax takes the
  other one).  Exact ``peak_idx`` order is therefore not a property of
  either package.  Held instead: where the positions differ, the port's
  own scores at the two lags are within 1e-4 of each other; header reads,
  counters and chips are compared peak by peak after matching the peaks
  by position.
* Chips: the LS product sums 9720 float32 terms in another order, so each
  chip is held within 1e-4 of its row's largest chip (the lam=1e-6 rows of
  non-frame windows reach |chip| ~ 800).
* Everything after the chips is a function of the chips alone; run on the
  JAX stage's chips, the port reproduces every integer output exactly,
  the 61 integer bytes of the host row included; the soft rows, header
  scores and the float32 evidence bytes of the host row within 1e-4.  The
  full stage's ``crc_ok`` is not held exactly: the clean loud-host clip's
  hard-pass candidates are rounding-adjacent, and the JAX package itself
  decodes 6 or 8 of them depending on how XLA compiled the stage.
* Verdicts, and the ladder's accepting stage, are row-identical.
"""
import secrets

import numpy as np
import pytest
import torch

from echoseal_torch.convert import V2_TABLE_DTYPES, numpy_tables_of
from echoseal_torch.core import profiles as pprof
from echoseal_torch.core.params import WIDE_DELTA
from echoseal_torch.models import pipeline as PP
from echoseal_torch.models import robust as probust
from echoseal_tpu.core import profiles as jprof
from echoseal_tpu.models import pipeline as JPL
from echoseal_tpu.models import robust as jrobust
from echoseal_tpu.utils import channels
from torch_port_util import two_torch_threads  # noqa: F401

FS = 48_000
T = int(3.5 * FS)
TPAD = 1 << 18
MAX_CTR = 4096
TOL = dict(rtol=1e-4, atol=1e-4)
INT_KEYS = ("peak_idx", "hdr_ok", "hdr_lo16", "ctr")
DECODE_KEYS = ("hdr_ok", "hdr_lo16", "ctr", "crc_ok", "ok", "blob",
               "blob_ctr", "scl_ctr")


TIE_SEED = 230      # the corpus seed whose float32 sync ties two lags


def v2_corpus(key32, seed: int):
    """4 v2 clips: clean loud-host, MP3-sim, silence+AWGN(+4dB), no wm.

    Every random byte of the two streams comes from ``seed`` through the
    port's ``RobustEmbedder(rng=...)``, which is bit-equal to the JAX TX
    (``test_embedder_matches_jax_with_pinned_randomness``), so both
    packages see the same clips on every run.
    """
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(T) / FS)
            ).astype(np.float32)
    tx_loud = probust.RobustEmbedder(key32,
                                     rng=np.random.default_rng(2 * seed))
    tx_loud._session_nonce = b"sessionA"
    wm_loud = tx_loud.process(host)
    tx_sil = probust.RobustEmbedder(key32,
                                    rng=np.random.default_rng(2 * seed + 1))
    tx_sil._session_nonce = b"sessionB"
    wm_sil = tx_sil.process(np.zeros(T, np.float32))
    rms = float(np.sqrt(np.mean(wm_sil**2)))
    rng = np.random.default_rng(3)
    clips = np.zeros((4, TPAD), np.float32)
    clips[0, :T] = wm_loud
    clips[1, :T] = channels.codec_sim(wm_loud, 128.0)[:T]
    clips[2, :T] = wm_sil + rms * 10 ** (-4 / 20) * rng.standard_normal(
        T).astype(np.float32)
    clips[3, :T] = 0.05 * rng.standard_normal(T).astype(np.float32)
    return clips, np.full(4, T, dtype=np.int32)


@pytest.fixture(scope="module")
def v2_batch(key32):
    return v2_corpus(key32, 0)


@pytest.fixture(scope="module")
def both(key32):
    """The JAX verifier and the port's on identical tables."""
    jv = JPL.RobustBatchVerifier(key32, max_ctr=MAX_CTR)
    pv = PP.RobustBatchVerifier.from_tables(
        key32, numpy_tables_of(jv, V2_TABLE_DTYPES), device="cpu")
    return jv, pv


@pytest.fixture(scope="module")
def stages(both, v2_batch):
    """Both stages' outputs per sync precision, computed once each."""
    jv, pv = both
    clips, nv = v2_batch
    cache = {}

    def get(sync_dtype):
        if sync_dtype not in cache:
            cache[sync_dtype] = _run_both(jv, pv, clips, nv, sync_dtype)
        return cache[sync_dtype]
    return get


def _run_both(jv, pv, clips, nv, sync_dtype):
    return ({k: np.asarray(v) for k, v in
             jv.run_device(clips, nv, sync_dtype=sync_dtype).items()},
            {k: v.numpy() for k, v in
             pv.run_device(clips, nv, sync_dtype=sync_dtype).items()})


def _no_headers(self, raw):
    n = raw.shape[0]
    return np.zeros(n, bool), np.full(n, 1.0, np.float32)


def _spy_scl(monkeypatch):
    """Record the pending mask of every ``_scl_fallback`` call."""
    seen: list[np.ndarray] = []
    orig = PP.RobustBatchVerifier._scl_fallback

    def spy(self, out, pending, expected_nonce, details=None):
        seen.append(pending.copy())
        return orig(self, out, pending, expected_nonce, details=details)

    monkeypatch.setattr(PP.RobustBatchVerifier, "_scl_fallback", spy)
    return seen


# ------------------------------------------------------------ host designs
def test_profiles_and_standard_spec_match_jax():
    for p, j in ((pprof.COMPAT, jprof.COMPAT), (pprof.ROBUST, jprof.ROBUST),
                 (pprof.v2_profile(360), jprof.v2_profile(360))):
        assert (p.name, p.oversample, p.standard_info_set, p.payload_k,
                p.span, p.frame_chips) == (
            j.name, j.oversample, j.standard_info_set, j.payload_k,
            j.span, j.frame_chips)
    assert pprof.v2_profile() is pprof.ROBUST
    for K in (448, 360):
        ps, js = pprof.polar_spec_standard(K=K), jprof.polar_spec_standard(K=K)
        np.testing.assert_array_equal(ps.frozen, js.frozen)
        np.testing.assert_array_equal(ps.data_pos, js.data_pos)
        np.testing.assert_array_equal(ps.crc_mat, js.crc_mat)
    for p, j in ((pprof.COMPAT, jprof.COMPAT), (pprof.ROBUST, jprof.ROBUST)):
        np.testing.assert_array_equal(pprof.profile_spec(p).frozen,
                                      jprof.profile_spec(j).frozen)
    with pytest.raises(ValueError):
        pprof.WaveformProfile("x", 1, False, payload_k=360)
    with pytest.raises(ValueError):
        pprof.v2_profile(361)


def test_demod_designs_and_key_tables_match_jax(key32, both):
    """Templates and the band-0 LS matrices to 1e-6; key tables exactly."""
    jv, _ = both
    S = pprof.ROBUST.oversample
    np.testing.assert_allclose(probust.robust_templates(FS, S),
                               jrobust.robust_templates(FS, S), atol=1e-6)
    lo, hi = probust.BAND_PLAN[0]
    for p, lam in enumerate(probust.LAM_PROFILES):
        np.testing.assert_allclose(
            probust.robust_demod_matrix(lo, hi, FS, S, lam),
            np.asarray(jv._m_stack[0, p]), rtol=1e-6, atol=1e-6)
    assert probust.LAM_PROFILES == jrobust.LAM_PROFILES
    assert probust.MIN_CLIP_SECONDS == jrobust.MIN_CLIP_SECONDS
    sec = PP.SecureChannel(key32)
    pn, hop = PP._key_tables(sec, PP.hop_schedule(key32), MAX_CTR)
    np.testing.assert_array_equal(pn, np.asarray(jv._pn_table))
    np.testing.assert_array_equal(hop, np.asarray(jv._hop_table))
    np.testing.assert_array_equal(PP.bits_to_bpsk(sec.pn_bits(0, 128)),
                                  np.asarray(jv._hdr_pn_sy))


def test_embedder_matches_jax_with_pinned_randomness(key32, monkeypatch):
    """Same random bytes in the same order -> the same samples."""
    jrng = np.random.default_rng(5)
    monkeypatch.setattr(secrets, "token_bytes", lambda n: jrng.bytes(n))
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(25_000) / FS)
            ).astype(np.float32)
    want = jrobust.RobustEmbedder(key32).process(host)
    tx = probust.RobustEmbedder(key32, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(tx.process(host), want)
    assert tx.frame_ctr == 3


# -------------------------------------------------------------- the stage
def _match_peaks(jo, po, clips, pv, sync_dtype):
    """Port rank of each JAX peak (same position), -1 where unmatched.

    Where the two packages' positions differ at a rank, the port's own
    scores at the two lags must tie within 1e-4.
    """
    j_idx, p_idx = jo["peak_idx"], po["peak_idx"]
    for i, b, k in np.argwhere(p_idx != j_idx):
        corr = PP.demod.normalized_xcorr(
            torch.from_numpy(clips[i]), pv.tables["templates"],
            compute_dtype=None if sync_dtype == "f32"
            else PP.resolve_sync_dtype(sync_dtype))[b]
        gap = abs(float(corr[j_idx[i, b, k]]) - float(corr[p_idx[i, b, k]]))
        assert gap <= 1e-4, (i, b, k, j_idx[i, b, k], p_idx[i, b, k], gap)
    same = j_idx[..., :, None] == p_idx[..., None, :]    # (B, 4, Kj, Kp)
    return np.where(same.any(-1), same.argmax(-1), -1)


STAGE_CASES = [("f32", 0), ("bf16", 0), ("f32", TIE_SEED)]


@pytest.mark.parametrize(
    "sync_dtype,seed", STAGE_CASES,
    ids=[d if s == 0 else f"{d}-seed{s}" for d, s in STAGE_CASES])
def test_stage_sync_header_and_chips_match(key32, both, stages, v2_batch,
                                           sync_dtype, seed):
    if seed == 0:
        clips, _ = v2_batch
        jo, po = stages(sync_dtype)
    else:
        clips, nv = v2_corpus(key32, seed)
        jo, po = _run_both(*both, clips, nv, sync_dtype)
    np.testing.assert_allclose(po["peak_val"], jo["peak_val"], **TOL)
    rank = _match_peaks(jo, po, clips, both[1], sync_dtype)
    matched = rank >= 0
    # almost every peak has its twin; the ties are a handful at most
    assert matched.mean() >= 0.95
    if seed == 0:
        assert matched.all()     # this corpus has no tie: exact positions
    take = np.maximum(rank, 0)
    assert po["chips"].shape == jo["chips"].shape == (4, 4, 2, 4, 1215)
    for k in ("hdr_ok", "hdr_lo16", "ctr"):      # (B, 4, NP, K)
        got = np.take_along_axis(po[k], take[:, :, None, :], axis=-1)
        ok = matched[:, :, None, :]
        np.testing.assert_array_equal(np.where(ok, got, 0),
                                      np.where(ok, jo[k], 0), err_msg=k)
    chips = np.take_along_axis(po["chips"], take[:, :, None, :, None], axis=3)
    row_err = np.abs(chips - jo["chips"]).max(-1)
    lim = 1e-4 * np.abs(jo["chips"]).max(-1)
    assert np.all((row_err <= lim) | ~matched[:, :, None, :]), row_err.max()
    assert po["host_packed"].shape == (4, 65)


@pytest.mark.parametrize("sync_dtype", ["f32", "bf16"])
def test_decode_of_jax_chips_is_exact(both, stages, sync_dtype):
    """Header -> counter -> LLR -> hard decode -> soft rows -> host row."""
    _, pv = both
    jo, _ = stages(sync_dtype)
    out = PP._decode_stage(
        *(torch.tensor(jo[k]) for k in ("chips", "peak_idx", "peak_val")),
        pv.tables, spec=pv._spec, span=pv.span, soft_rows=4)
    out = {k: v.numpy() for k, v in out.items()}
    for k in DECODE_KEYS:
        np.testing.assert_array_equal(out[k], jo[k], err_msg=k)
    np.testing.assert_array_equal(out["host_packed"][:, :61],
                                  jo["host_packed"][:, :61])
    q = [pv._parse_evidence(o["host_packed"])[1] for o in (out, jo)]
    np.testing.assert_allclose(q[0], q[1], **TOL)
    np.testing.assert_allclose(out["scl_llr"], jo["scl_llr"], **TOL)
    np.testing.assert_allclose(out["hdr_score"], jo["hdr_score"], **TOL)


# ------------------------------------------------------------- the ladder
def test_full_ladder_verdicts_match_jax(both, v2_batch):
    jv, pv = both
    clips, nv = v2_batch
    details = {}
    v_p = pv.verify_batch(clips, nv, details=details)
    v_j = jv.verify_batch(clips, nv)
    assert v_p.tolist() == v_j.tolist() == [True, True, True, False]
    hard_p = pv.verify_batch(clips, nv, use_scl=False)
    hard_j = jv.verify_batch(clips, nv, use_scl=False)
    assert not hard_p[2] and not hard_j[2] and not hard_p[3]
    assert details[2].stage == "scl" and details[2].session_nonce == b"sessionB"
    assert {details[i].session_nonce for i in (0, 1)} == {b"sessionA"}
    assert {r[:2] for r in pv.scl_rungs} <= {("0:1", 8), ("0:1", 32),
                                             ("1:4", 8), ("1:4", 32)}


def test_futility_gate_skips_headerless_clips(both, v2_batch, monkeypatch):
    """Headerless noise never reaches the SCL fallback; pure noise skips it."""
    _, pv = both
    clips, nv = v2_batch
    seen = _spy_scl(monkeypatch)
    assert pv.verify_batch(clips, nv).tolist() == [True, True, True, False]
    assert seen and all(not p[3] for p in seen)
    seen.clear()
    noise = (0.05 * np.random.default_rng(7).standard_normal(clips.shape)
             ).astype(np.float32)
    assert not pv.verify_batch(noise, nv).any()
    assert seen == []


def test_futility_valve_escalates_headerless_clips(key32, both, v2_batch,
                                                   monkeypatch):
    """With every header masked, the gate drops the SCL clips; the valve
    (``futility_qfloor=0.0``) lets them through again."""
    jv, pv = both
    clips, nv = v2_batch
    monkeypatch.setattr(PP.RobustBatchVerifier, "_parse_evidence", _no_headers)
    monkeypatch.setattr(PP.RobustBatchVerifier, "_near_start_mask",
                        lambda self, out: np.zeros(4, bool))
    hard = pv.verify_batch(clips, nv, use_scl=False)
    assert not hard[2]
    assert pv.verify_batch(clips, nv).tolist() == hard.tolist()
    valve = PP.RobustBatchVerifier.from_tables(
        key32, {k: v.numpy() for k, v in pv.tables.items()}, device="cpu",
        futility_qfloor=0.0)
    assert valve.verify_batch(clips, nv).tolist() == [True, True, True, False]


def test_near_start_headerless_auto_rescue(both, v2_batch, monkeypatch):
    """Headerless clips cut at the stream start re-enter the SCL ladder."""
    _, pv = both
    clips, nv = v2_batch
    monkeypatch.setattr(PP.RobustBatchVerifier, "_parse_evidence", _no_headers)
    seen = _spy_scl(monkeypatch)
    assert pv.verify_batch(clips, nv).tolist() == [True, True, True, False]
    assert seen and all(not p[3] for p in seen)
    seen.clear()
    noise = (0.05 * np.random.default_rng(11).standard_normal(clips.shape)
             ).astype(np.float32)
    assert not pv.verify_batch(noise, nv).any()
    assert seen == []


def test_near_start_mask_math():
    """Aligned near-start peaks escalate; uniform noise peaks and aligned
    peaks past the wide window do not (tensors or numpy both accepted)."""
    span = pprof.ROBUST.span
    P = 4
    idx = np.zeros((3, 4, P), np.int32)
    val = np.zeros((3, 4, P), np.float32)
    rng = np.random.default_rng(0)
    ctrs = np.arange(16).reshape(4, P)
    idx[0] = ctrs * span + rng.integers(-2, 3, (4, P))
    idx[1] = rng.integers(0, 300 * span, (4, P))
    idx[2] = (WIDE_DELTA + ctrs) * span + rng.integers(-2, 3, (4, P))
    pv = object.__new__(PP.RobustBatchVerifier)
    pv.span = span
    jv = object.__new__(JPL.RobustBatchVerifier)
    jv.span = span
    want = jv._near_start_mask({"peak_idx": idx, "peak_val": val})
    got = pv._near_start_mask({"peak_idx": torch.from_numpy(idx),
                               "peak_val": torch.from_numpy(val)})
    assert got.tolist() == want.tolist() == [True, False, False]


def test_staged_scl_ladder_verdict_parity(both, v2_batch, monkeypatch):
    _, pv = both
    clips, nv = v2_batch
    staged = pv.verify_batch(clips, nv)
    monkeypatch.setattr(PP, "SCL_LADDER", ())
    fixed = pv.verify_batch(clips, nv)
    assert [r[1] for r in pv.scl_rungs] == [32] * len(pv.scl_rungs)
    assert staged.tolist() == fixed.tolist() == [True, True, True, False]


def test_parse_evidence_compat_width():
    from types import SimpleNamespace

    fake = SimpleNamespace(_spec=pprof.profile_spec(pprof.ROBUST))
    hdr, q = PP.RobustBatchVerifier._parse_evidence(
        fake, np.zeros((3, 60), np.uint8))
    assert hdr.all() and np.isinf(q).all()


def test_later_candidate_rescues_false_crc_pass(both, stages):
    """A wrong decode passing CRC-8 first does not mask a later one (C2).

    The JAX v2 hard pass opens only the first CRC-passing candidate, so
    this clip fails it there and waits for the SCL rung; the port's hard
    pass opens the later ones at once.
    """
    _, pv = both
    _, po = stages("bf16")
    out = {k: torch.from_numpy(v.copy()) for k, v in po.items()}
    crc = out["crc_ok"].reshape(4, -1)
    assert int(crc[0].sum()) >= 2
    first = int(torch.argmax(crc[0].to(torch.int32)))
    garbage = np.random.default_rng(3).integers(0, 256, 55).astype(np.uint8)
    info = out["info_bits"].reshape(4, crc.shape[1], -1)
    info[0, first] = torch.from_numpy(np.unpackbits(garbage).astype(np.int32))
    out["host_packed"][0, 5:60] = torch.from_numpy(garbage)
    details = {}
    hard = pv._finish_ladder(out, None, False, 1 << 20, details=details)
    assert hard[0] and details[0].stage == "hard"
    later = np.flatnonzero(crc[0].numpy())[1]
    assert details[0].frame_ctr == int(out["ctr"].reshape(4, -1)[0, later])


def test_port_tx_to_port_rx_and_extended_counters(key32, both):
    """The port's seeded TX -> both RXs; counter 70 000 via ``ext_ctr``."""
    jv, pv = both
    clips = np.zeros((4, TPAD), np.float32)
    for i, ctr in enumerate((0, 120, 3000, 70_000)):
        tx = probust.RobustEmbedder(key32, rng=np.random.default_rng(i))
        tx.frame_ctr = ctr
        clips[i, :T] = tx.process(np.zeros(T, np.float32))
    nv = np.full(4, T, np.int32)
    details = {}
    assert pv.verify_batch(clips, nv, details=details).tolist() == [True] * 4
    assert jv.verify_batch(clips, nv).tolist() == [True] * 4
    assert details[3].stage == "ext_ctr"
    assert 70_000 <= details[3].frame_ctr < 70_000 + 18
    assert not pv.finish_host(pv.run_device(clips[3:], nv[3:])).any()


def test_device_rule_and_unported_options(key32, both, monkeypatch):
    _, pv = both
    # fs_in is ported (tests/test_torch_recover.py): a silent 44.1 kHz row
    # is ingested and rejected, it no longer raises
    assert pv.verify_batch(np.zeros((1, 1 << 16), np.float32),
                           fs_in=44_100).tolist() == [False]
    with pytest.raises(ValueError):
        PP.resolve_sync_dtype("bfloat16")
    assert PP.resolve_sync_dtype(None) is torch.bfloat16
    assert PP.resolve_sync_dtype("f32") is torch.float32
    with pytest.raises(ValueError, match="float32"):
        PP.RobustBatchVerifier(key32, table_dtype="bf16", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PP.RobustBatchVerifier(key32, max_ctr=16)
