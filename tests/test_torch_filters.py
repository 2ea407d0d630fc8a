"""echoseal_torch filters, polar encoder and batch TX vs echoseal_tpu's.

The same numpy inputs go through the JAX function (on the CPU) and its
port twin.  Tolerances: the recursions and the FFT FIR within 1e-5 of the
JAX twin relative to the output's peak, and of scipy in float64;
``encode_batch`` exact; the batch frame synthesis within 2e-5 of the JAX
device synthesis and of the golden frames (the tolerance of
tests/test_embedder.py).
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import lfilter, sosfilt

from echoseal_torch.core.bandplan import BAND_PLAN, hop_schedule
from echoseal_torch.core.crypto import SecureChannel
from echoseal_torch.core.params import FRAME_LEN, HDR_L, PRE_L
from echoseal_torch.core.sequences import bits_to_bpsk, header_bits_batch, mls63
from echoseal_torch.models import embedder as pemb
from echoseal_torch.ops import demod as pdemod
from echoseal_torch.ops import filters as pf
from echoseal_torch.ops import polar as ppolar
from echoseal_tpu.models import embedder as jemb
from echoseal_tpu.ops import filters as jf
from echoseal_tpu.ops import polar as jpolar
from torch_port_util import two_torch_threads  # noqa: F401

FS = 48_000
GOLD = np.load(Path(__file__).parent / "golden" / "reference_vectors.npz")
HOST_DESIGNS = ("butter_coeffs", "butter_sos", "impulse_response",
                "matched_filter_taps", "preamble_template", "fir_from_iir")


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("name", HOST_DESIGNS)
def test_host_designs_equal_jax(name):
    for lo, hi in BAND_PLAN:
        got, want = getattr(pf, name)(lo, hi, FS), getattr(jf, name)(lo, hi, FS)
        for g, w in zip(*(r if isinstance(r, tuple) else (r,)
                          for r in (got, want))):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_band_stacks_equal_jax():
    np.testing.assert_array_equal(pf.all_band_sos(FS), jf.all_band_sos(FS))
    for g, w in zip(pf.all_band_coeffs(FS), jf.all_band_coeffs(FS)):
        np.testing.assert_array_equal(g, w)


def test_sos_apply_per_band_with_chained_state():
    """Per-row band filters, two segments chained through zf -> zi."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((4, 600)).astype(np.float32)
    sos = pf.all_band_sos(FS)                              # (4, 4, 6)
    ya, za = pf.sos_apply(torch.from_numpy(sos), torch.from_numpy(x[:, :250]))
    yb, zb = pf.sos_apply(torch.from_numpy(sos), torch.from_numpy(x[:, 250:]),
                          zi=za)
    ja, jza = jf.sos_apply(jnp.asarray(sos), jnp.asarray(x[:, :250]))
    jb, jzb = jf.sos_apply(jnp.asarray(sos), jnp.asarray(x[:, 250:]), zi=jza)
    got = torch.cat([ya, yb], -1).numpy()
    _close(got, np.concatenate([np.asarray(ja), np.asarray(jb)], -1))
    _close(zb.numpy(), np.asarray(jzb))
    assert zb.shape == (4, 4, 2)
    want = np.stack([sosfilt(pf.butter_sos(lo, hi, FS), x[b].astype(np.float64))
                     for b, (lo, hi) in enumerate(BAND_PLAN)])
    _close(got, want)
    whole, _ = pf.sos_apply(torch.from_numpy(sos), torch.from_numpy(x))
    _close(whole.numpy(), want)


def test_iir_apply_shared_filter_with_chained_state():
    """A 1-D (b, a) shared by a (2, 3, T) batch; state chained as scipy's."""
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 3, 400)).astype(np.float32)
    # a low-order filter: the 8th-order band-pass in float32 direct form
    # is ill-conditioned in both packages alike (hence sos_apply)
    b = np.array([0.2, 0.3, 0.1])
    a = np.array([1.0, -0.5, 0.25])
    ya, za = pf.iir_apply(b, a, torch.from_numpy(x[..., :150]))
    yb, zb = pf.iir_apply(b, a, torch.from_numpy(x[..., 150:]), zi=za)
    ja, jza = jf.iir_apply(b, a, jnp.asarray(x[..., :150]))
    jb, jzb = jf.iir_apply(b, a, jnp.asarray(x[..., 150:]), zi=jza)
    got = torch.cat([ya, yb], -1).numpy()
    _close(got, np.concatenate([np.asarray(ja), np.asarray(jb)], -1))
    _close(zb.numpy(), np.asarray(jzb))
    s1, z1 = lfilter(b, a, x[..., :150].astype(np.float64),
                     zi=np.zeros((2, 3, 2)))
    s2, z2 = lfilter(b, a, x[..., 150:].astype(np.float64), zi=z1)
    _close(got, np.concatenate([s1, s2], -1))
    _close(zb.numpy(), z2)


def test_iir_apply_per_row_filters():
    """(4, 3) per-row coefficients, as a 4-band filterbank passes them."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((4, 300)).astype(np.float32)
    bs = rng.standard_normal((4, 3))
    r, w = rng.uniform(0.3, 0.9, 4), rng.uniform(0.2, 2.8, 4)
    ars = np.stack([np.ones(4), -2 * r * np.cos(w), r * r], axis=1)
    got, zf = pf.iir_apply(bs, ars, torch.from_numpy(x))
    want, jzf = jf.iir_apply(jnp.asarray(bs), jnp.asarray(ars), jnp.asarray(x))
    _close(got.numpy(), np.asarray(want))
    _close(zf.numpy(), np.asarray(jzf))
    _close(got.numpy(), np.stack([lfilter(bs[i], ars[i], x[i].astype(np.float64))
                                  for i in range(4)]))
    assert zf.shape == (4, 2)


def test_fir_apply_and_fft_convolve():
    rng = np.random.default_rng(24)
    x = rng.standard_normal((3, 5000)).astype(np.float32)
    lo, hi = BAND_PLAN[1]
    h = pf.fir_from_iir(lo, hi, FS)
    got = pf.fir_apply(torch.from_numpy(h), torch.from_numpy(x)).numpy()
    _close(got, np.asarray(jf.fir_apply(jnp.asarray(h), jnp.asarray(x))))
    want = np.stack([np.convolve(r.astype(np.float64), h.astype(np.float64))
                     for r in x])
    _close(got, want[:, :5000])
    full = pf.fft_convolve_full(torch.from_numpy(x), torch.from_numpy(h))
    assert full.shape == (3, 5000 + h.size - 1) and full.dtype == torch.float32
    _close(full.numpy(), want)
    # the truncated FIR stands in for the IIR itself
    b, a = pf.butter_coeffs(lo, hi, FS)
    _close(got, lfilter(b, a, x.astype(np.float64)), tol=1e-5)


@pytest.mark.parametrize("standard", [False, True])
def test_encode_batch_is_exact(standard):
    from echoseal_torch.core import profiles as pprof
    from echoseal_tpu.core import profiles as jprof

    pspec = pprof.polar_spec_standard() if standard else ppolar.polar_spec()
    jspec = jprof.polar_spec_standard() if standard else jpolar.polar_spec()
    rng = np.random.default_rng(25)
    payloads = [rng.bytes(55) for _ in range(6)]
    info = np.stack([np.unpackbits(np.frombuffer(p, np.uint8))
                     for p in payloads]).reshape(2, 3, 440)
    got = ppolar.encode_batch(torch.from_numpy(info), pspec)
    assert got.dtype == torch.int32 and got.shape == (2, 3, 1024)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpolar.encode_batch(jnp.asarray(info), jspec)))
    np.testing.assert_array_equal(
        got.numpy().reshape(6, 1024),
        np.stack([ppolar.encode_np(p, pspec) for p in payloads]))


def _synth_inputs(key32, ctrs, payloads):
    sec = SecureChannel(key32)
    info = np.stack([np.unpackbits(np.frombuffer(p, np.uint8))
                     for p in payloads])
    pn = sec.pn_bits_batch(ctrs, FRAME_LEN)[:, PRE_L + HDR_L:]
    return (sec, info, header_bits_batch(ctrs), pn,
            bits_to_bpsk(sec.pn_bits(0, HDR_L)), bits_to_bpsk(mls63()),
            hop_schedule(key32).indices(ctrs))


def test_synthesize_frames_device_golden_and_jax(key32):
    """Toeplitz-product synthesis vs the golden frames and the JAX scan."""
    ctrs = np.array([0, 5, 1000, 7, 8, 9, 10, 11])
    rng = np.random.default_rng(26)
    payloads = [GOLD["payloads"][0].tobytes()] * 3 + [rng.bytes(55)
                                                      for _ in range(5)]
    _, info, hdr, pn, hdr_pn, pre, bidx = _synth_inputs(key32, ctrs, payloads)
    assert len(set(bidx.tolist())) > 1          # more than one band group
    got = pemb.synthesize_frames_device(
        *(torch.from_numpy(np.ascontiguousarray(a))
          for a in (info, hdr, pn, hdr_pn, pre, bidx)),
        torch.from_numpy(pdemod.all_forward_matrices(FS))).numpy()
    assert got.shape == (8, FRAME_LEN) and got.dtype == np.float32
    want = np.asarray(jemb.synthesize_frames_device(
        jnp.asarray(info), jnp.asarray(hdr), jnp.asarray(pn),
        jnp.asarray(hdr_pn), jnp.asarray(pre),
        jnp.asarray(jf.all_band_sos(FS)[bidx])))
    np.testing.assert_allclose(got, want, atol=2e-5)
    for i, c in enumerate((0, 5, 1000)):
        np.testing.assert_allclose(got[i], GOLD[f"frame_{c}"], atol=2e-5)


def test_synthesis_applies_the_peak_guard(key32):
    """A frame whose peak passes FRAME_PEAK_GUARD is scaled to peak 1."""
    from echoseal_torch.core.params import FRAME_PEAK_GUARD

    ctrs = np.arange(4)
    _, info, hdr, pn, hdr_pn, pre, bidx = _synth_inputs(
        key32, ctrs, [bytes(55)] * 4)
    t_fwd = torch.from_numpy(pdemod.all_forward_matrices(FS))
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (info, hdr, pn, hdr_pn, pre, bidx)]
    plain = pemb.synthesize_frames_device(*args, t_fwd)
    loud = pemb.synthesize_frames_device(*args, 4.0 * t_fwd)
    assert float(plain.abs().max()) <= FRAME_PEAK_GUARD
    raw_peak = 4.0 * plain.abs().amax(-1)
    assert bool((raw_peak > FRAME_PEAK_GUARD).all())
    np.testing.assert_allclose(loud.abs().amax(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(
        loud.numpy(), (plain / plain.abs().amax(-1, keepdim=True)).numpy(),
        atol=1e-6)


def test_batch_embedder_seeded_as_frames_np(key32):
    """``frames_device(rng=)`` seals the payloads ``frames_np(rng=)`` does."""
    be = pemb.BatchEmbedder(key32, device="cpu")
    ctrs = np.array([0, 3, 7, 42, 70_000])
    got = be.frames_device(ctrs, b"12345678", rng=np.random.default_rng(4))
    assert isinstance(got, torch.Tensor) and got.shape == (5, FRAME_LEN)
    want = pemb.frames_np(be.sec, be._hop, ctrs, b"12345678",
                          rng=np.random.default_rng(4))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    again = be.frames(ctrs, b"12345678", rng=np.random.default_rng(4))
    np.testing.assert_array_equal(again, got.numpy())
    fresh = be.frames(ctrs, b"12345678")
    assert not np.allclose(fresh, again)        # unseeded: new random bytes


def test_batch_embedder_stream_and_embed(key32):
    """``chip_stream`` cuts whole frames; ``embed`` keeps the mix law."""
    from echoseal_torch.core.params import MIX_HEADROOM

    be = pemb.BatchEmbedder(key32, device="cpu")
    chips = be.chip_stream(3000, start_ctr=5, session_nonce=bytes(8))
    assert chips.shape == (3000,) and chips.dtype == np.float32
    host = (0.97 * np.sign(np.sin(np.arange(4000) * 0.1))).astype(np.float32)
    out = be.embed(host, session_nonce=bytes(8))
    assert out.shape == host.shape
    assert float(np.abs(out).max()) <= MIX_HEADROOM + 1e-6
    quiet = be.embed(np.zeros(2 * FRAME_LEN, np.float32))
    assert float(np.abs(quiet).max()) > 0.0     # the floor keeps it alive


def test_batch_embedder_feeds_the_port_verifier(key32):
    """Device-made frames verify through the port's compat batch tier."""
    from echoseal_torch.models.pipeline import BatchVerifier

    be = pemb.BatchEmbedder(key32, device="cpu")
    T = 3 * FS
    n_frames = -(-T // FRAME_LEN)
    fr = be.frames(np.arange(40, 40 + n_frames), bytes(8),
                   rng=np.random.default_rng(9))
    clips = np.zeros((1, T + 8192), np.float32)
    clips[0, :T] = fr.reshape(-1)[:T] * 10.0 ** (-35.0 / 20.0)
    bv = BatchVerifier(key32, max_ctr=256, device="cpu")
    assert bv.verify_batch(clips, np.full(1, T, np.int32)).all()


def test_batch_embedder_device_rule(key32, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pemb.BatchEmbedder(key32)
