"""echoseal_torch demod ops and the payload-LLR kernel vs echoseal_tpu.

Seeded numpy inputs go through the JAX function and its port on the CPU.
Host designs are bit-equal (same float64 scipy code).  Float outputs of
the device functions match within rtol = atol = 1e-4, the contract of
tests/test_pallas.py; integer and bool outputs match exactly.
``refine_chips`` is held on a well-conditioned synthetic forward model:
with the real lam=1e-12 inversion the result moves with float32 rounding
order alone (see tests/test_torch_pipeline.py), so there only accuracy
against a float64 run can be compared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echoseal_torch.core.bandplan import BAND_PLAN
from echoseal_torch.core.params import FRAME_LEN, HDR_L, PRE_L
from echoseal_torch.ops import demod as P
from echoseal_torch.ops import llr as L
from echoseal_tpu.ops import demod as J
from torch_port_util import two_torch_threads  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
FS = 48_000


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("band", range(4))
def test_host_designs_bit_equal(band):
    lo, hi = BAND_PLAN[band]
    np.testing.assert_array_equal(P.demod_matrix_direct(lo, hi, FS),
                                  J.demod_matrix_direct(lo, hi, FS))
    np.testing.assert_array_equal(P.forward_matrix_direct(lo, hi, FS),
                                  J.forward_matrix_direct(lo, hi, FS))
    np.testing.assert_array_equal(P.sync_templates(FS)[band],
                                  J.sync_templates(FS)[band])


def test_slice_windows_negative_and_late_starts(rng):
    x = rng.standard_normal((3, 500)).astype(np.float32)
    starts = np.array([[-9, 0, 17], [480, 490, -1], [5, 200, 477]], np.int32)
    got = P.slice_windows(t(x), t(starts), 24).numpy()
    want = np.asarray(J.slice_windows(jnp.asarray(x), jnp.asarray(starts), 24))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], x[0, :24])     # -9 -> 0
    np.testing.assert_array_equal(got[1, 0], x[1, -24:])    # 480 -> 476
    s1 = np.array([-3, 100, 499])
    np.testing.assert_array_equal(
        P.slice_windows(t(x[0]), t(s1), 10).numpy(),
        np.asarray(J.slice_windows(jnp.asarray(x[0]), jnp.asarray(s1), 10)))


def test_normalized_xcorr(rng):
    x = rng.standard_normal((2, 3, 3000)).astype(np.float32)
    x[..., 2000:] = 0.0                          # zero padding, energy 0
    tpl = P.sync_templates(FS)
    got = P.normalized_xcorr(t(x), t(tpl)).numpy()
    want = np.asarray(J.normalized_xcorr(jnp.asarray(x), jnp.asarray(tpl)))
    assert got.shape == want.shape == (2, 3, 4, 3000 - 62)
    np.testing.assert_allclose(got, want, **TOL)


def test_topk_nms(rng):
    corr = rng.standard_normal((3, 4, 5000)).astype(np.float32)
    corr[0, 0, 4990:] = 9.0                      # peak run at the right edge
    corr[1, 2, :] = -np.inf                      # nothing valid
    gi, gv = P.topk_nms(t(corr), 3, 607)
    wi, wv = J.topk_nms(jnp.asarray(corr), 3, 607)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert gi.dtype == torch.int32


def test_topk_nms_ties_take_first_index():
    corr = np.zeros((1, 2000), np.float32)
    corr[0, [300, 700, 1500]] = 5.0              # three equal maxima
    gi, _ = P.topk_nms(t(corr), 3, 200)
    wi, _ = J.topk_nms(jnp.asarray(corr), 3, 200)
    assert gi.tolist() == [[300, 700, 1500]] == np.asarray(wi).tolist()


def _synthetic_frames(rng, B=2, F=2, N=3, K=256):
    """Well-conditioned forward model + noisy windows of +-amp chips."""
    T = (np.eye(K) + 0.3 * np.tril(rng.standard_normal((F, K, K))) / np.sqrt(K))
    M = np.linalg.solve(np.swapaxes(T, 1, 2) @ T + 1e-3 * np.eye(K),
                        np.swapaxes(T, 1, 2))
    pre = np.where(rng.random(PRE_L) < 0.5, -1.0, 1.0)
    c = np.where(rng.random((B, F, N, K)) < 0.5, -1.0, 1.0)
    c[..., :PRE_L] = pre
    amp = rng.uniform(0.5, 2.0, (B, F, N, 1))
    win = np.einsum("fwk,bfnk->bfnw", T, c * amp)
    win += 0.6 * amp * rng.standard_normal(win.shape)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(win), f32(T), f32(M), f32(pre)


def test_demod_and_refine_chips(rng):
    win, T, M, pre = _synthetic_frames(rng)
    chips = P.demod_chips(t(win), t(M))
    j_chips = jnp.einsum("bfnw,fkw->bfnk", win, M,
                         precision="highest")
    np.testing.assert_allclose(chips.numpy(), np.asarray(j_chips), **TOL)
    got = P.refine_chips(t(win), chips, t(T), t(M), t(pre), iters=4).numpy()
    want = np.asarray(J.refine_chips(
        jnp.asarray(win), jnp.asarray(chips.numpy()),
        jnp.asarray(T)[None, :, None], jnp.asarray(M)[None, :, None],
        jnp.asarray(pre), iters=4))
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.allclose(got, chips.numpy(), **TOL)   # it did refine


def test_preamble_score_and_header_decode(rng):
    hdr_pn = np.where(rng.random(HDR_L) < 0.5, -1.0, 1.0).astype(np.float32)
    pre = np.where(rng.random(PRE_L) < 0.5, -1.0, 1.0).astype(np.float32)
    bits = np.repeat(rng.integers(0, 2, (5, 4, 16)), 8, axis=-1)
    chips = rng.standard_normal((5, 4, FRAME_LEN)).astype(np.float32)
    chips[..., PRE_L:PRE_L + HDR_L] += (2.0 * bits - 1.0) * hdr_pn * \
        rng.uniform(0.0, 3.0, (5, 4, 1))
    chips = chips.astype(np.float32)
    np.testing.assert_allclose(
        P.preamble_score(t(chips), t(pre)).numpy(),
        np.asarray(J.preamble_score(jnp.asarray(chips), jnp.asarray(pre))),
        **TOL)
    got = P.header_decode(t(chips), t(hdr_pn))
    want = J.header_decode(jnp.asarray(chips), jnp.asarray(hdr_pn))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)
    assert 0 < int(got[0].sum()) < got[0].numel()      # both outcomes seen


def test_resolve_counters(rng):
    from echoseal_torch.models.pipeline import _resolve_counters as p_res
    from echoseal_tpu.models.pipeline import _resolve_counters as j_res

    max_ctr = 700
    hop = rng.integers(0, 4, max_ctr).astype(np.int32)
    shp = (6, 4, 2)
    hdr_ok = rng.random(shp) < 0.5
    lo16 = rng.integers(0, 1000, shp).astype(np.int32)
    ctr_est = rng.integers(-50, 900, shp).astype(np.int32)
    band = np.arange(4, dtype=np.int32)[None, :, None]
    got = p_res(t(hdr_ok), t(lo16), t(ctr_est), t(hop), t(band), max_ctr)
    want = j_res(jnp.asarray(hdr_ok), jnp.asarray(lo16), jnp.asarray(ctr_est),
                 jnp.asarray(hop), jnp.asarray(band), max_ctr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _llr_inputs(rng, n):
    chips = (rng.standard_normal((n, FRAME_LEN)) * 0.01).astype(np.float32)
    chips[: n // 2, PRE_L + HDR_L:] += 0.02       # some rows with signal
    pn = (2.0 * rng.integers(0, 2, (n, 1024)) - 1.0).astype(np.float32)
    return chips, pn


@pytest.mark.parametrize("n", [13, 64])
def test_payload_llr_plain_matches_jax(rng, n):
    chips, pn = _llr_inputs(rng, n)
    got = L.payload_llr_plain(t(chips), t(pn)).numpy()
    want = np.asarray(J.payload_llr(jnp.asarray(chips), jnp.asarray(pn)))
    np.testing.assert_allclose(got, want, **TOL)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = L.build.LAUNCHES["payload_llr"]
    np.testing.assert_array_equal(L.payload_llr(t(chips), t(pn)).numpy(), got)
    assert L.build.LAUNCHES["payload_llr"] == before


def test_payload_llr_plain_matches_pallas_interpret(rng):
    from echoseal_tpu.ops.pallas.llr_kernel import payload_llr_pallas

    chips, pn = _llr_inputs(rng, 13)    # not a multiple of the row block
    want = np.asarray(payload_llr_pallas(
        jnp.asarray(chips[:, PRE_L + HDR_L:]), jnp.asarray(pn),
        interpret=True))
    np.testing.assert_allclose(L.payload_llr_plain(t(chips), t(pn)).numpy(),
                               want, **TOL)
