"""echoseal_torch's CUDA kernels and their wrappers, without JAX.

This file imports neither JAX nor echoseal_tpu, so it also runs where only
torch is installed.  On a machine with a card (which has no JAX, and so
cannot load tests/conftest.py), run it as

    python -m pytest --noconftest tests/test_torch_kernels.py

The kernel tests skip without a CUDA device: a CUDA kernel has no CPU mode.
The plain versions they are held against are themselves held against the
JAX package in tests/test_torch_demod.py.
"""
import numpy as np
import pytest
import torch

from echoseal_torch.core.params import FRAME_LEN, HDR_L, PRE_L
from echoseal_torch.core.profiles import polar_spec_standard
from echoseal_torch.ops import build, llr, polar

TOL = dict(rtol=1e-4, atol=1e-4)
SPECS = {"compat": polar.polar_spec, "standard-448": polar_spec_standard}


def _llr_inputs(n, device, seed=0, lead=None):
    """``n`` rows of chips and PN, shaped ``lead + (width,)`` (default (n,))."""
    rng = np.random.default_rng(seed)
    chips = (rng.standard_normal((n, FRAME_LEN)) * 0.01).astype(np.float32)
    chips[: n // 2, PRE_L + HDR_L:] += 0.02       # some rows with signal
    pn = (2.0 * rng.integers(0, 2, (n, 1024)) - 1.0).astype(np.float32)
    lead = lead or (n,)
    return (torch.from_numpy(chips.reshape(*lead, FRAME_LEN)).to(device),
            torch.from_numpy(pn.reshape(*lead, 1024)).to(device))


def test_payload_llr_cpu_tensors_take_plain_version():
    chips, pn = _llr_inputs(13, "cpu")
    before = build.LAUNCHES["payload_llr"]
    assert torch.equal(llr.payload_llr(chips, pn),
                       llr.payload_llr_plain(chips, pn))
    assert build.LAUNCHES["payload_llr"] == before


def test_payload_llr_rejects_other_devices():
    chips = torch.zeros(2, FRAME_LEN, device="meta")
    with pytest.raises(ValueError):
        llr.payload_llr(chips, torch.zeros(2, 1024, device="meta"))
    with pytest.raises(ValueError):
        llr.payload_llr(torch.zeros(2, FRAME_LEN),
                        torch.zeros(2, 1024, device="meta"))


def test_kernel_sources_found():
    assert build.sources() == ["payload_decode", "payload_llr"]
    assert build.library_path("payload_llr").name.startswith("libpayload_llr-")
    assert build.library_path("payload_decode").name.startswith(
        "libpayload_decode-")


def _decode_inputs(n, device, spec, seed=0, lead=None, m=64):
    """``n`` rows of chips carrying real codewords under noise that rises
    along the rows (some pass the CRC, some fail), an (m, 1024) uint8 PN
    bit table and each row's int64 table index, some out of range."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2, (m, 1024)).astype(np.uint8)
    idx = rng.integers(0, m, n)
    book = np.stack([polar.encode_np(rng.bytes(spec.info_len // 8), spec)
                     for _ in range(16)])
    sent = (2.0 * book[rng.integers(0, 16, n)] - 1.0) * \
        (2.0 * table[idx] - 1.0)
    sigma = np.linspace(0.05, 1.6, n)[:, None]
    chips = (0.05 * rng.standard_normal((n, FRAME_LEN))).astype(np.float32)
    chips[:, PRE_L + HDR_L:] = 0.05 * (
        sent + sigma * rng.standard_normal(sent.shape))
    idx[::7] += m                                   # clamped to m - 1
    lead = lead or (n,)
    return (torch.from_numpy(chips.reshape(*lead, FRAME_LEN)).to(device),
            torch.from_numpy(table).to(device),
            torch.from_numpy(idx.reshape(lead)).to(device))


def test_payload_decode_cpu_tensors_take_plain_version():
    spec = polar.polar_spec()
    chips, table, idx = _decode_inputs(13, "cpu", spec)
    before = build.LAUNCHES["payload_decode"]
    got = llr.payload_decode(chips, table, idx, spec, want_llr=True)
    want = llr.payload_decode_plain(chips, table, idx, spec, want_llr=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert build.LAUNCHES["payload_decode"] == before


def test_payload_decode_rejects_other_devices():
    spec = polar.polar_spec()
    chips, table, idx = _decode_inputs(2, "cpu", spec)
    for args in ((chips.to("meta"), table.to("meta"), idx.to("meta")),
                 (chips, table.to("meta"), idx),
                 (chips, table, idx.to("meta"))):
        with pytest.raises(ValueError):
            llr.payload_decode(*args, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [(13,), (8192,), (1024, 4, 2, 4)],
                         ids=["13", "8192", "v2-32768"])
def test_payload_llr_kernel_on_card(lead):
    """The CUDA kernel equals the plain version on the card.

    N = 13 leaves a ragged last block (8 warps per block); N = 8192 is the
    compat path's B * 4 * P at B = 1024, and (1024, 4, 2, 4) the v2 path's
    (B, band, lam profile, peak) lattice, 32 768 rows.  The kernel reorders
    the row sums, so the tolerance is the 1e-4 of the TPU kernel's own test.
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    chips, pn = _llr_inputs(int(np.prod(lead)), "cuda", lead=lead)
    before = build.LAUNCHES["payload_llr"]
    got = llr.payload_llr(chips, pn)
    torch.cuda.synchronize()
    assert build.LAUNCHES["payload_llr"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               llr.payload_llr_plain(chips, pn).cpu().numpy(),
                               **TOL)
    with pytest.raises(ValueError):                  # column-major chips
        llr.payload_llr(chips.mT.contiguous().mT, pn)
    with pytest.raises(ValueError):                  # float64 input
        llr.payload_llr(chips.double(), pn.double())


@pytest.mark.cuda
@pytest.mark.parametrize("want_llr", [False, True], ids=["hard", "llr"])
@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("lead", [(13,), (37,), (800,), (8192,),
                                  (1024, 4, 2, 4)],
                         ids=["13", "37", "800", "8192", "v2-32768"])
def test_payload_decode_kernel_on_card(lead, spec_name, want_llr):
    """The fused kernel equals its plain version on the card.

    Rows 13 (a ragged last block), 37 and 800 (single-clip candidate
    counts), 8192 (the compat batch path) and the v2 lattice.  Info bits
    and crc_ok must be exact: each hard bit is the sign of the kernel's own
    LLR, and the sign of 2 a z / s2 is the sign of z whatever the rounding
    of a and s2.  LLRs within the 1e-4 of the TPU kernel's own test.
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    spec = SPECS[spec_name]()
    chips, table, idx = _decode_inputs(int(np.prod(lead)), "cuda", spec,
                                       lead=lead)
    before = build.LAUNCHES["payload_decode"]
    got = llr.payload_decode(chips, table, idx, spec, want_llr=want_llr)
    torch.cuda.synchronize()
    assert build.LAUNCHES["payload_decode"] == before + 1
    want = llr.payload_decode_plain(chips, table, idx, spec, want_llr=True)
    assert 0 < int(want[2].sum()) < want[2].numel()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    if want_llr:
        np.testing.assert_allclose(got[0].cpu().numpy(),
                                   want[0].cpu().numpy(), **TOL)
    else:
        assert got[0] is None
    # int32 indices and an int8 table give the same
    got32 = llr.payload_decode(chips, table.to(torch.int8),
                               idx.to(torch.int32), spec)
    assert torch.equal(got32[1], want[1]) and torch.equal(got32[2], want[2])


@pytest.mark.cuda
def test_payload_decode_refusals_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    spec = polar.polar_spec()
    chips, table, idx = _decode_inputs(64, "cuda", spec)
    before = build.LAUNCHES["payload_decode"]
    bad = [
        (chips.double(), table, idx),                    # float64 chips
        (chips, table.float(), idx),                     # float PN table
        (chips, table, idx.to(torch.int16)),             # int16 rows
        (chips.mT.contiguous().mT, table, idx),          # column-major
        (chips, table.mT.contiguous().mT, idx),
        (chips, table, idx[::2]),                        # row count
        (chips, table[:, :512], idx),                    # table width
        (chips, table[:0], idx),                         # empty table
        (chips, table.cpu(), idx),                       # mixed devices
        (chips, table, idx.cpu()),
        (chips.cpu(), table, idx),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            llr.payload_decode(*args, spec)
    with pytest.raises(ValueError):                      # not N = 1024
        llr.payload_decode(chips, table, idx, polar.polar_spec(N=512, K=256))
    assert build.LAUNCHES["payload_decode"] == before
