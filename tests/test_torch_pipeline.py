"""echoseal_torch compat batch verify vs echoseal_tpu's, on the CPU.

Same clips (the tests/test_pipeline.py batch: 8 watermarked 3 s clips in
2**18-sample rows, ``max_ctr`` 4096) and the same tables (carried across
with ``convert.tables_from_numpy``) go through both verifiers.

What is held, and why:

* Everything up to the chip estimates is exact or within 1e-4: peaks,
  header reads, counters, the chosen offset's preamble score.
* Everything after them (header, counter, LLR, hard decode, the packed
  verdict row) is a function of the chips alone; run on the JAX stage's
  chips, the port reproduces every integer output exactly.
* The chips themselves come from the lam=1e-12 exact inversion, whose
  condition number is ~1e5: float32 rounding order alone moves a chip by
  ~2% of its amplitude, and now and then tips a marginal candidate's
  bit-flip descent the other way.  So the chips are held by accuracy: the
  port's distance from a float64 run of the same stage is no larger than
  the JAX package's, within a factor of 1.25.
* Verdicts are row-identical: clean, noise, wrong key, a clip past the PN
  table (counter 70 000), and the port's own TX.
"""
import numpy as np
import pytest
import torch

from echoseal_torch.core.params import FRAME_LEN
from echoseal_torch.models import pipeline as PP
from echoseal_torch.models.embedder import frames_np
from echoseal_tpu.models.embedder import BatchEmbedder
from echoseal_tpu.models.pipeline import BatchVerifier as JVerifier
from torch_port_util import two_torch_threads  # noqa: F401

FS = 48_000
T = 3 * FS
TPAD = 1 << 18
N_FRAMES = -(-T // FRAME_LEN)
SCALE = 10.0 ** (-35.0 / 20.0)
TABLE_KEYS = ("templates", "m_direct", "t_fwd", "pre_sy", "hdr_pn_sy",
              "pn_table", "hop_table")
TOL = dict(rtol=1e-4, atol=1e-4)


def _tables(jv):
    return {k: np.asarray(getattr(jv, "_" + k)) for k in TABLE_KEYS}


def _clips(frames_of, starts):
    clips = np.zeros((len(starts), TPAD), dtype=np.float32)
    for i, sc in enumerate(starts):
        fr = frames_of(np.arange(sc, sc + N_FRAMES))
        clips[i, :T] = fr.reshape(-1)[:T] * SCALE
    return clips, np.full(len(starts), T, dtype=np.int32)


@pytest.fixture(scope="module")
def both(key32):
    """The batch, both verifiers on identical tables, and both outputs."""
    be = BatchEmbedder(key32)
    starts = np.random.default_rng(1).integers(0, 2000, 8)
    clips, nv = _clips(lambda c: be.frames(c, session_nonce=bytes(8)), starts)
    jv = JVerifier(key32, max_ctr=4096)
    pv = PP.BatchVerifier.from_tables(key32, _tables(jv), device="cpu")
    jo = {k: np.asarray(v) for k, v in jv.run_device(clips, nv).items()}
    po = {k: v.numpy() for k, v in pv.run_device(clips, nv).items()}
    return dict(clips=clips, nv=nv, jv=jv, pv=pv, jo=jo, po=po)


def test_port_tables_equal_jax_tables(key32, both):
    pv = PP.BatchVerifier(key32, max_ctr=4096, device="cpu")
    jt = _tables(both["jv"])
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(pv.tables[k].numpy(), jt[k], err_msg=k)


def test_sync_and_header_outputs_match(both):
    jo, po = both["jo"], both["po"]
    for k in ("peak_idx", "hdr_ok", "hdr_lo16", "ctr"):
        np.testing.assert_array_equal(po[k], jo[k], err_msg=k)
    np.testing.assert_allclose(po["peak_val"], jo["peak_val"], **TOL)
    np.testing.assert_allclose(po["pre_score"], jo["pre_score"], **TOL)


def test_decode_of_jax_chips_is_exact(both):
    """Header -> counter -> LLR -> hard decode -> row, on the JAX chips."""
    jo = both["jo"]
    out = PP._decode_stage(*(torch.tensor(jo[k]) for k in
                             ("chips", "peak_idx", "peak_val")),
                           both["pv"].tables)
    for k in ("hdr_ok", "hdr_lo16", "ctr", "crc_ok", "info_bits",
              "host_packed", "ok", "blob", "blob_ctr"):
        np.testing.assert_array_equal(out[k].numpy(), jo[k], err_msg=k)
    np.testing.assert_allclose(out["hdr_score"].numpy(), jo["hdr_score"], **TOL)
    assert jo["crc_ok"].sum() >= 40            # most candidates decode


def test_chips_as_accurate_as_jax(both):
    """Port and JAX chips stand equally close to a float64 run."""
    pv, jo, po = both["pv"], both["jo"], both["po"]
    t64 = {k: v.double() if v.is_floating_point() else v
           for k, v in pv.tables.items()}
    ref = PP._batch_verify_stage(
        torch.from_numpy(both["clips"]).double(), torch.from_numpy(both["nv"]),
        t64, peaks=pv.peaks)["chips"].numpy()
    err_j = np.median(np.abs(jo["chips"] - ref).max(-1))
    err_p = np.median(np.abs(po["chips"] - ref).max(-1))
    amp = np.median(np.abs(ref))
    assert err_p <= 1.25 * err_j and err_j < 0.05 * amp, (err_p, err_j, amp)
    agree = np.mean(np.sign(po["chips"]) == np.sign(jo["chips"]))
    assert agree > 0.995, agree


def test_clean_clips_verdicts(both):
    v_p = both["pv"].verify_batch(both["clips"], both["nv"])
    v_j = both["jv"].verify_batch(both["clips"], both["nv"])
    assert v_p.tolist() == v_j.tolist() == [True] * 8


def test_noise_and_wrong_key_verdicts(key32, both):
    noise = (0.05 * np.random.default_rng(7).standard_normal(
        both["clips"].shape)).astype(np.float32)
    v_p = both["pv"].verify_batch(noise, both["nv"])
    v_j = both["jv"].verify_batch(noise, both["nv"])
    assert v_p.tolist() == v_j.tolist() == [False] * 8
    bad = bytes.fromhex("99" * 32)
    v_p = PP.BatchVerifier(bad, max_ctr=4096, device="cpu").verify_batch(
        both["clips"], both["nv"])
    v_j = JVerifier(bad, max_ctr=4096).verify_batch(both["clips"], both["nv"])
    assert v_p.tolist() == v_j.tolist() == [False] * 8


def test_counter_past_pn_table(key32, both):
    """A clip cut at counter 70 000 verifies only via the extended pass."""
    be = BatchEmbedder(key32)
    clips, nv = _clips(lambda c: be.frames(c, session_nonce=bytes(8)),
                       [70_000])
    pv, jv = both["pv"], both["jv"]
    assert not pv.finish_host(pv.run_device(clips, nv)).any()
    assert not jv.finish_host(jv.run_device(clips, nv)).any()
    details = {}
    assert pv.verify_batch(clips, nv, details=details).tolist() == [True]
    assert jv.verify_batch(clips, nv).tolist() == [True]
    d = details[0]
    assert d.stage == "ext_ctr" and d.session_nonce == bytes(8)
    assert 70_000 <= d.frame_ctr < 70_000 + N_FRAMES


def test_port_tx_to_port_rx(key32, both):
    pv = both["pv"]
    starts = np.random.default_rng(5).integers(0, 3000, 4)
    clips, nv = _clips(
        lambda c: frames_np(pv.sec, pv._hop, c, b"portsess"), starts)
    details = {}
    v_p = pv.verify_batch(clips, nv, details=details,
                          expected_nonce=b"portsess")
    v_j = both["jv"].verify_batch(clips, nv, expected_nonce=b"portsess")
    assert v_p.tolist() == v_j.tolist() == [True] * 4
    assert all(details[i].stage == "hard" for i in range(4))
    assert not pv.verify_batch(clips, nv, expected_nonce=b"othersss").any()


def test_entry_shapes_run(key32):
    """The shapes ``__graft_entry__.entry`` compiles: B=2, T=2**17, 512."""
    pv = PP.BatchVerifier(key32, max_ctr=512, device="cpu")
    out = pv.run_device(np.zeros((2, 1 << 17), np.float32))
    assert out["host_packed"].shape == (2, 60)
    assert out["chips"].shape == (2, 4, PP.DEFAULT_PEAKS, FRAME_LEN)
    assert not pv.verify_batch(np.zeros((2, 1 << 17), np.float32)).any()


def test_device_rule_and_tf32_flags(key32, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PP.BatchVerifier(key32, max_ctr=16)
    torch.backends.cudnn.allow_tf32 = True
    pv = PP.BatchVerifier(key32, max_ctr=16, device="cpu")
    assert pv.device.type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_later_candidate_rescues_false_crc_pass(key32, both):
    """A wrong decode that passes CRC-8 first does not mask a later one.

    The clip's first CRC-passing candidate is overwritten with garbage that
    still claims a CRC pass (in its bits and in the packed row); the host
    finish then opens the clip's other CRC-passing candidates and accepts
    on the first that authenticates.
    """
    pv = both["pv"]
    out = {k: torch.from_numpy(v.copy()) for k, v in both["po"].items()}
    crc = out["crc_ok"].reshape(8, -1)
    i = int(np.flatnonzero(crc.sum(1).numpy() >= 2)[0])
    first = int(torch.argmax(crc[i].to(torch.int32)))
    garbage = np.random.default_rng(3).integers(0, 256, 55).astype(np.uint8)
    info = out["info_bits"].reshape(8, crc.shape[1], -1)
    info[i, first] = torch.from_numpy(np.unpackbits(garbage).astype(np.int32))
    out["host_packed"][i, 5:] = torch.from_numpy(garbage)
    details = {}
    verdicts = pv.finish_host_detailed(out, details=details)[0]
    assert verdicts.tolist() == [True] * 8
    later = np.flatnonzero(crc[i].numpy())[1]
    assert details[i].stage == "hard"
    assert details[i].frame_ctr == int(out["ctr"].reshape(8, -1)[i, later])
    assert not pv.finish_host(out, expected_nonce=b"othersss").any()


def test_accept_scan_counts(key32):
    """The rejection scan on a tiny CPU batch: every clip authenticates."""
    from echoseal_torch.tools.accept_scan import scan_run

    pv = PP.BatchVerifier(key32, max_ctr=4096, device="cpu")
    starts = np.array([5, 900]) * FRAME_LEN
    rec = scan_run(pv, starts, np.random.default_rng(0))
    assert rec["clips"] == 2 and rec["candidates"] == 16
    assert rec["rejects"] == rec["no_authentic"] == 0
    assert rec["first_rule_rejects"] == 0 and rec["crc_fail"] < 16
