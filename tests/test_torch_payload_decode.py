"""echoseal_torch's fused payload decode vs echoseal_tpu's LLR + hard decode.

``ops/llr.py::payload_decode`` computes, per row, the PN gather, the payload
LLRs and the hard-decision polar decode with its CRC-8; on the card it is
one kernel (``csrc/payload_decode.cu``, held against its plain version in
tests/test_torch_kernels.py), on the CPU its plain version.  Here the same
seeded numpy inputs -- real codewords of the compat spec and the standard
specs at K = 448 and 360, under noise of several levels so that some rows
pass the CRC and some fail -- go through
``echoseal_tpu.ops.polar.hard_decode_batch(echoseal_tpu.ops.demod.payload_llr(...))``
and through the port.  Info bits and ``crc_ok`` must match exactly, LLRs
within rtol = atol = 1e-4 (the contract of tests/test_pallas.py).  Also: the
LLR part against the Pallas kernel in interpret mode, every accepted index
and table type against the float-PN form, the clamp of out-of-range rows,
the rejected all-zero word, and the per-(spec, device) table cache.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echoseal_torch.core.params import FRAME_LEN, HDR_L, PRE_L
from echoseal_torch.core.profiles import polar_spec_standard as p_standard
from echoseal_torch.models import detector as PD
from echoseal_torch.ops import build
from echoseal_torch.ops import llr as L
from echoseal_torch.ops import polar as P
from echoseal_tpu.core.profiles import polar_spec_standard as j_standard
from echoseal_tpu.ops import demod as JD
from echoseal_tpu.ops import polar as JP
from torch_port_util import two_torch_threads  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
OFF = PRE_L + HDR_L
SPECS = {
    "compat": (P.polar_spec, JP.polar_spec),
    "standard-448": (lambda: p_standard(K=448), lambda: j_standard(K=448)),
    "standard-360": (lambda: p_standard(K=360), lambda: j_standard(K=360)),
}


def _inputs(spec, n: int, seed: int, m: int = 9):
    """``n`` rows of chips carrying real codewords, an (m, 1024) PN bit
    table and each row's table index.

    Row noise rises from 0.05 to 1.6 of the chip amplitude, and every
    fourth row is despread with the wrong table row, so some rows pass the
    CRC and some fail.
    """
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2, (m, spec.N)).astype(np.int8)
    idx = rng.integers(0, m, n).astype(np.int64)
    cw = np.stack([P.encode_np(rng.bytes(spec.info_len // 8), spec)
                   for _ in range(n)])
    sent = (2.0 * cw - 1.0) * (2.0 * table[idx] - 1.0)
    sigma = np.linspace(0.05, 1.6, n)[:, None]
    chips = 0.3 * rng.standard_normal((n, FRAME_LEN))
    chips[:, OFF:] = 0.3 * (sent + sigma * rng.standard_normal(sent.shape))
    idx[::4] = (idx[::4] + 1) % m
    return chips.astype(np.float32), table, idx


def _jax_chain(chips, pn_sy, jspec):
    llr = JD.payload_llr(jnp.asarray(chips), jnp.asarray(pn_sy))
    info, ok = JP.hard_decode_batch(llr, jspec)
    return np.asarray(llr), np.asarray(info), np.asarray(ok)


@pytest.mark.parametrize("n", [13, 37])
@pytest.mark.parametrize("name", list(SPECS))
def test_plain_matches_jax(name, n):
    pspec, jspec = (make() for make in SPECS[name])
    chips, table, idx = _inputs(pspec, n, seed=n)
    pn_sy = (2.0 * table[idx] - 1.0).astype(np.float32)
    j_llr, j_info, j_ok = _jax_chain(chips, pn_sy, jspec)
    assert 0 < j_ok.sum() < n                # passing and failing rows

    args = (torch.from_numpy(chips), torch.from_numpy(table),
            torch.from_numpy(idx), pspec)
    p_llr, p_info, p_ok = L.payload_decode_plain(*args, want_llr=True)
    np.testing.assert_allclose(p_llr.numpy(), j_llr, **TOL)
    np.testing.assert_array_equal(p_info.numpy(), j_info)
    np.testing.assert_array_equal(p_ok.numpy(), j_ok)
    assert p_info.dtype == torch.int32 and p_ok.dtype == torch.bool

    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = build.LAUNCHES["payload_decode"]
    w_llr, w_info, w_ok = L.payload_decode(*args)
    assert w_llr is None
    assert torch.equal(w_info, p_info) and torch.equal(w_ok, p_ok)
    assert build.LAUNCHES["payload_decode"] == before


def test_llr_part_matches_pallas_interpret():
    from echoseal_tpu.ops.pallas.llr_kernel import payload_llr_pallas

    spec = P.polar_spec()
    chips, table, idx = _inputs(spec, 13, seed=5)   # not a multiple of 8
    want = np.asarray(payload_llr_pallas(
        jnp.asarray(chips[:, OFF:]),
        jnp.asarray((2.0 * table[idx] - 1.0).astype(np.float32)),
        interpret=True))
    got, _, _ = L.payload_decode_plain(
        torch.from_numpy(chips), torch.from_numpy(table),
        torch.from_numpy(idx), spec, want_llr=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("table_dtype", [torch.int8, torch.uint8])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_table_and_index_equal_float_pn(table_dtype, idx_dtype):
    """Every accepted (table, index) type gives what the float-PN chain
    gives -- the detector's ``_llr_stage`` in its +-1 symbol form."""
    spec = p_standard(K=448)
    chips, table, idx = _inputs(spec, 37, seed=11)
    pn_sy = torch.from_numpy(2.0 * table[idx] - 1.0).to(torch.float32)
    want = PD._llr_stage(torch.from_numpy(chips), pn_sy, spec)
    got = L.payload_decode(
        torch.from_numpy(chips), torch.from_numpy(table).to(table_dtype),
        torch.from_numpy(idx).to(idx_dtype), spec, want_llr=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ref_llr = L.payload_llr_plain(torch.from_numpy(chips), pn_sy)
    assert torch.equal(want[0], ref_llr)
    for g, w in zip(got[1:], P.hard_decode_batch(ref_llr, spec)):
        assert torch.equal(g, w)


def test_out_of_range_rows_clamp():
    spec = P.polar_spec()
    chips, table, _ = _inputs(spec, 13, seed=3)
    m = table.shape[0]
    idx = np.array([-5, -1, 0, m - 1, m, m + 7, 2**40] * 2, np.int64)[:13]
    clamped = np.clip(idx, 0, m - 1)
    got, want = (L.payload_decode_plain(
        torch.from_numpy(chips), torch.from_numpy(table),
        torch.from_numpy(i), spec, want_llr=True) for i in (idx, clamped))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", list(SPECS))
def test_all_zero_word_rejected(name):
    """Chips whose hard bits are all 0 decode to the all-zero word: its CRC
    checks, but no real payload is all-zero, so the row is rejected."""
    pspec, jspec = (make() for make in SPECS[name])
    rng = np.random.default_rng(4)
    table = rng.integers(0, 2, (2, pspec.N)).astype(np.uint8)
    idx = np.array([0, 1, 1], np.int64)
    pn_sy = (2.0 * table[idx] - 1.0).astype(np.float32)
    chips = np.zeros((3, FRAME_LEN), np.float32)
    chips[:, OFF:] = -pn_sy * (0.5 + rng.random((3, pspec.N)))
    _, info, ok = L.payload_decode(torch.from_numpy(chips),
                                   torch.from_numpy(table),
                                   torch.from_numpy(idx), pspec)
    _, j_info, j_ok = _jax_chain(chips, pn_sy, jspec)
    assert not info.any() and not ok.any()
    np.testing.assert_array_equal(info.numpy(), j_info)
    np.testing.assert_array_equal(ok.numpy(), j_ok)


def test_spec_tables_uploaded_once(monkeypatch):
    """After the first call per (spec, device), the hard decode, the CRC
    check, the SCL's CRC and the encoder copy no numpy table to the device:
    the cache returns the same tensors."""
    spec = p_standard(K=360)
    cpu = torch.device("cpu")
    tabs = P.device_tables(spec, cpu)
    assert P.device_tables(spec, cpu) is tabs
    chips, table, idx = _inputs(spec, 13, seed=8)
    llr, _, _ = L.payload_decode_plain(
        torch.from_numpy(chips), torch.from_numpy(table),
        torch.from_numpy(idx), spec, want_llr=True)
    first = P.hard_decode_batch(llr, spec)
    info = first[0]

    uploads = []
    as_tensor = torch.as_tensor

    def spy(data, *args, **kwargs):
        if isinstance(data, np.ndarray):
            uploads.append(data.shape)
        return as_tensor(data, *args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", spy)
    again = P.hard_decode_batch(llr, spec)
    ok = P.crc8_check_batch(info, info[..., :8], tabs.crc_mat)
    P.encode_batch(info, spec)
    assert uploads == []
    assert P.device_tables(spec, cpu) is tabs
    for g, w in zip(again, first):
        assert torch.equal(g, w)
    assert torch.equal(ok, P.crc8_check_batch(info, info[..., :8],
                                              spec.crc_mat))

    # the kernel's tables: each code position's data index, each info
    # bit's CRC column byte
    want_role = np.full(spec.N, -1)
    want_role[spec.data_pos] = np.arange(spec.K)
    np.testing.assert_array_equal(tabs.role.numpy(), want_role)
    np.testing.assert_array_equal(
        np.unpackbits(tabs.crc_cols.numpy()[:, None], axis=1,
                      bitorder="little"), spec.crc_mat)
