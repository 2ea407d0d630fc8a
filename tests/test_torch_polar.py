"""echoseal_torch polar code: structure, encoder, CRC and hard decoder.

The same seeded numpy inputs go through ``echoseal_tpu.ops.polar`` and the
port; every output is bits or bools, so every comparison is exact.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echoseal_torch.ops import polar as P
from echoseal_tpu.ops import polar as J
from torch_port_util import two_torch_threads  # noqa: F401

GOLD = np.load(Path(__file__).parent / "golden" / "reference_vectors.npz")


def test_spec_matches_jax_package():
    p, j = P.polar_spec(), J.polar_spec()
    np.testing.assert_array_equal(p.frozen, j.frozen)
    np.testing.assert_array_equal(p.data_pos, j.data_pos)
    np.testing.assert_array_equal(p.crc_mat, j.crc_mat)
    assert (p.N, p.K, p.info_len) == (1024, 448, 440)


def test_encode_golden_codewords():
    for i in range(GOLD["payloads"].shape[0]):
        np.testing.assert_array_equal(
            P.encode_np(GOLD["payloads"][i].tobytes()), GOLD["codewords"][i])


def test_polar_transform_matches_jax_package(rng):
    u = rng.integers(0, 2, size=(3, 5, 1024)).astype(np.int32)
    got = P.polar_transform(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(J.polar_transform(jnp.asarray(u))))
    np.testing.assert_array_equal(got.astype(np.uint8),
                                  P.polar_transform_np(u))


def test_crc_check_matches_jax_package(rng):
    spec = P.polar_spec()
    bits = rng.integers(0, 2, size=(6, 440)).astype(np.int32)
    crcs = np.stack([P.crc8_bits(b) for b in bits]).astype(np.int32)
    crcs[::2, 3] ^= 1                     # half the rows carry a bad CRC
    got = P.crc8_check_batch(torch.from_numpy(bits), torch.from_numpy(crcs),
                             spec.crc_mat).numpy()
    want = np.asarray(J.crc8_check_batch(jnp.asarray(bits), jnp.asarray(crcs),
                                         spec.crc_mat))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [False, True] * 3


@pytest.mark.parametrize("sigma", [0.0, 0.3, 0.6, 1.2])
def test_hard_decode_noisy_matches_jax_package(rng, sigma):
    """Noisy LLRs around real codewords: info bits and CRC flags equal."""
    payloads = [rng.bytes(55) for _ in range(16)]
    cw = np.stack([P.encode_np(p) for p in payloads]).astype(np.float32)
    llr = ((2.0 * cw - 1.0)
           + sigma * rng.standard_normal(cw.shape)).astype(np.float32) * 4.0
    info, ok = P.hard_decode_batch(torch.from_numpy(llr), P.polar_spec())
    j_info, j_ok = J.hard_decode_batch(jnp.asarray(llr), J.polar_spec())
    np.testing.assert_array_equal(info.numpy(), np.asarray(j_info))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    if sigma == 0.0:
        assert ok.all()
        assert [P.pack_info_bits(r) for r in info.numpy()] == payloads


def test_hard_decode_rejects_all_zero_word():
    info, ok = P.hard_decode_batch(-torch.ones(2, 1024), P.polar_spec())
    assert not ok.any() and int(info.sum()) == 0
