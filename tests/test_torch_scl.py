"""echoseal_torch's SCL list decoder vs echoseal_tpu's dense oracle, on the CPU.

``_scl_decode_dense`` is the JAX package's direct transcription of the
list-decode recursion, kept as the oracle for its production decoders
(tests/test_scl_proof.py).  The port's one exact decoder is held against it
on both specs (compat ``polar_spec()`` and the v2 ``profile_spec(ROBUST)``,
whose info set has the repetition subtrees) with the same inputs: sorted
metrics within rtol 1e-4 / atol 1e-3 (the shortcuts sum penalties in
another order), and the identical set of CRC-passing payloads.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echoseal_torch.core import profiles as pprof
from echoseal_torch.ops import polar as ppolar
from echoseal_torch.ops import scl as pscl
from echoseal_tpu.core import profiles as jprof
from echoseal_tpu.ops import polar as jpolar
from echoseal_tpu.ops import scl as jscl
from torch_port_util import two_torch_threads  # noqa: F401


def _specs(which):
    if which == "compat":
        return jpolar.polar_spec(), ppolar.polar_spec()
    return jprof.profile_spec(jprof.ROBUST), pprof.profile_spec(pprof.ROBUST)


def _coded(spec, n, sigma, seed):
    """(payloads, float32 LLRs) of ``n`` encoded payloads through AWGN."""
    rng = np.random.default_rng(seed)
    payloads = [rng.bytes(spec.info_len // 8) for _ in range(n)]
    bits = np.stack([jpolar.encode_np(p, spec) for p in payloads])
    y = (2.0 * bits - 1.0) + sigma * rng.standard_normal(bits.shape)
    return payloads, (2.0 * y / (sigma * sigma)).astype(np.float32)


def _passing(res, i):
    return {jpolar.pack_info_bits(r)
            for r in np.asarray(res["info_bits"][i])[np.asarray(res["crc_ok"][i])]}


def _port(llr, spec, L):
    return {k: v.numpy() for k, v in pscl.scl_decode(
        torch.from_numpy(llr), spec, L).items()}


def test_combines_and_penalties_match_jax():
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((3, 64)) * 8).astype(np.float32)[:2]
    u = rng.integers(0, 2, 64).astype(bool)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tol = dict(rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(pscl._f_combine(ta, tb).numpy(),
                               np.asarray(jscl._f_combine(a, b)), **tol)
    np.testing.assert_allclose(
        pscl._g_combine(ta, tb, torch.from_numpy(u)).numpy(),
        np.asarray(jscl._g_combine(a, b, jnp.asarray(u.astype(np.int32)))),
        **tol)
    for got, want in zip(pscl._penalties(ta), jscl._penalties(a)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    assert pscl.BIG_METRIC == jscl.BIG_METRIC


@pytest.mark.parametrize("sigma", [0.45, 0.3])
@pytest.mark.parametrize("L", [8, 32])
@pytest.mark.parametrize("which", ["compat", "v2"])
def test_scl_matches_dense_oracle(which, L, sigma):
    """Waterfall LLRs: sigma 0.45 and seed 99 as tests/test_scl_proof.py,
    and sigma 0.3 (the SCL-256 bench), where compat lists pass CRC too."""
    jspec, pspec = _specs(which)
    payloads, llr = _coded(jspec, 4, sigma, 99)
    oracle = jscl._scl_decode_dense(jnp.asarray(llr), jspec, L)
    got = _port(llr, pspec, L)
    assert got["info_bits"].shape == (4, L, jspec.info_len)
    assert got["info_bits"].dtype == np.int32
    np.testing.assert_allclose(np.sort(got["metrics"], -1),
                               np.sort(np.asarray(oracle["metrics"]), -1),
                               rtol=1e-4, atol=1e-3)
    assert np.all(np.diff(got["metrics"], axis=-1) >= 0)   # sorted lists
    for i in range(len(payloads)):
        assert _passing(got, i) == _passing(oracle, i), (which, L, i)
    if sigma < 0.4:
        assert got["crc_ok"].any()


@pytest.mark.parametrize("L", [1, 8])
@pytest.mark.parametrize("which", ["compat", "v2"])
def test_noiseless_decode_exact(which, L):
    """Clean codewords come back as the best path, CRC passing."""
    _, pspec = _specs(which)
    payloads, llr = _coded(pspec, 4, 1e-3, 7)
    llr = np.clip(llr, -16.0, 16.0)          # the pipeline's LLR range
    got = _port(llr, pspec, L)
    for i, p in enumerate(payloads):
        assert ppolar.pack_info_bits(got["info_bits"][i, 0]) == p
        assert got["crc_ok"][i, 0]


@pytest.mark.parametrize("which", ["compat", "v2"])
def test_zero_llr_tie_order_matches_oracle(which):
    """All-zero LLRs: every candidate ties, so list order is all tie order.

    The fork keeps ``lax.top_k``'s lower-index-first order and the final
    sort is stable, so the lists equal the oracle's path for path.
    """
    jspec, pspec = _specs(which)
    llr = np.zeros((4, jspec.N), np.float32)
    oracle = {k: np.asarray(v) for k, v in
              jscl._scl_decode_dense(jnp.asarray(llr), jspec, 8).items()}
    got = _port(llr, pspec, 8)
    np.testing.assert_array_equal(got["info_bits"], oracle["info_bits"])
    np.testing.assert_array_equal(got["crc_ok"], oracle["crc_ok"])
    np.testing.assert_allclose(got["metrics"], oracle["metrics"], rtol=1e-4,
                               atol=1e-3)


def test_scl_decode_np_device_rule(monkeypatch):
    spec = ppolar.polar_spec()
    payloads, llr = _coded(spec, 1, 1e-3, 3)
    llr = np.clip(llr, -16.0, 16.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pscl.scl_decode_np(llr[0], spec, 4)
    res = pscl.scl_decode_np(llr[0], spec, 4, device="cpu")
    assert res["info_bits"].shape == (4, spec.info_len)
    assert ppolar.pack_info_bits(res["info_bits"][0]) == payloads[0]
    with pytest.raises(ValueError):
        pscl.scl_decode(torch.zeros(2, 512), spec, 4)
    shuffled = dataclasses.replace(spec, data_pos=spec.data_pos[::-1].copy())
    with pytest.raises(ValueError, match="data_pos"):
        pscl.scl_decode(torch.zeros(2, spec.N), shuffled, 4)
