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
from echoseal_torch.ops import build, llr

TOL = dict(rtol=1e-4, atol=1e-4)


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
    assert build.sources() == ["payload_llr"]
    assert build.library_path("payload_llr").name.startswith("libpayload_llr-")


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
