"""The time-scale scan's plain version against echoseal_tpu's, CPU.

``robust.scale_scan_plain`` is the function of ``csrc/scale_scan.cu`` in
torch ops, along the kernel's overlap-save segments; the JAX package's scan
is one full-length FFT correlation.  Held: scores within 1e-4 and the
picked factor exactly, on ragged lengths, a row shorter than the bank
(all -inf), segments wholly past a row's length and rows whose width is no
multiple of a segment's lags; the spectra table; the wrapper's refusals,
banks wider than a quarter segment among them.
The kernel itself is held against this version on the card
(tests/test_torch_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echoseal_torch.core.profiles import ROBUST
from echoseal_torch.models import robust as probust
from echoseal_torch.ops import build
from echoseal_torch.utils import channels as pchannels
from echoseal_tpu.models import robust as jrobust
from torch_port_util import two_torch_threads  # noqa: F401

FS = 48_000
WIDTH = 45_000          # no multiple of a segment's lags


@pytest.fixture(scope="module")
def bank():
    return probust.scaled_template_bank(FS, ROBUST.oversample)


@pytest.fixture(scope="module")
def rows(key32, bank):
    """(6, WIDTH) rows and lengths: watermarked cuts played at 1.031,
    0.978 and 1.0, one cut short of a segment's end, one row shorter
    than the bank, one of noise ending a segment and a half in."""
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(WIDTH + 4000) / FS)
            ).astype(np.float32)
    wm = probust.RobustEmbedder(
        key32, rng=np.random.default_rng(3)).process(host)
    L = bank.shape[1]
    H = probust.SCAN_FFT_LEN - L + 1
    noise = (0.05 * np.random.default_rng(4).standard_normal(WIDTH)
             ).astype(np.float32)
    sig = [pchannels.time_scale(wm, f)[:WIDTH] for f in (1.031, 0.978, 1.0)]
    sig += [wm[:30_001], wm[:L - 1], noise[:H + H // 2]]
    x = np.zeros((len(sig), WIDTH), np.float32)
    nv = np.zeros(len(sig), np.int64)
    for i, y in enumerate(sig):
        x[i, :y.size] = y
        nv[i] = y.size
    x[4, L - 1:2 * L] = 0.3          # past n_valid: masked lags only
    return x, nv


def _jax(x, nv, bank):
    return np.asarray(jrobust._scale_scan_batch(
        jnp.asarray(x), jnp.asarray(nv.astype(np.int32)), jnp.asarray(bank)))


def _pick(s):
    grid = np.asarray(probust.SCALE_SCAN_GRID)
    return grid[s.reshape(s.shape[0], 31, 4).max(-1).argmax(-1)]


def test_scan_refuses_banks_wider_than_a_quarter_segment():
    """Segments of 4096 samples take banks of up to 1024 taps; the
    robust profile's bank has 530."""
    assert (probust.SCAN_FFT_LEN, probust.SCAN_MAX_L) == (4096, 1024)
    x = torch.zeros(1, 3000)
    nv = torch.tensor([3000])
    for L in (1, 530, 1024):
        got = probust._scale_scan_batch(x, nv, torch.ones(2, L))
        assert got.shape == (1, 2)
    for L in (1025, 2048):
        with pytest.raises(ValueError, match="1024"):
            probust._scale_scan_batch(x, nv, torch.ones(2, L))


def test_plain_matches_jax_on_ragged_rows(rows, bank):
    """Scores within 1e-4, -inf exactly where JAX has it (the row shorter
    than the bank), the picked factor of each finite row exactly."""
    x, nv = rows
    want = _jax(x, nv, bank)
    got = probust.scale_scan_plain(torch.from_numpy(x), torch.from_numpy(nv),
                                   torch.from_numpy(bank))
    assert got.shape == (6, 124) and got.dtype == torch.float32
    got = got.numpy()
    assert np.isneginf(want[4]).all()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert fin[[0, 1, 2, 3, 5]].all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-4)
    ok = [0, 1, 2, 3, 5]
    np.testing.assert_array_equal(_pick(got[ok]), _pick(want[ok]))
    assert _pick(got[:3]).tolist() == [0.97, 1.02333, 1.0]


def test_wrapper_takes_the_plain_version_on_the_cpu(rows, bank):
    x, nv = (torch.from_numpy(a) for a in rows)
    b = torch.from_numpy(bank)
    before = build.LAUNCHES["scale_scan"]
    got = probust._scale_scan_batch(x, nv, b)
    assert torch.equal(got, probust.scale_scan_plain(x, nv, b))
    # another row chunking, int32 lengths, the one-clip stage
    np.testing.assert_allclose(
        probust._scale_scan_batch(x, nv.int(), b, row_chunk=7).numpy(),
        got.numpy(), rtol=0, atol=1e-6)
    for i in (0, 4, 5):
        one = probust._scale_scan_stage(x[i], int(nv[i]), b)
        np.testing.assert_allclose(one.numpy(), got[i].numpy(), rtol=0,
                                   atol=1e-6)
    assert build.LAUNCHES["scale_scan"] == before


def test_segments_past_the_length_leave_scores_alone(rows, bank):
    """Samples past a row's last window move no score beyond the FFTs'
    rounding: lags there are masked, whole segments past it skipped."""
    x, nv = rows
    b = torch.from_numpy(bank)
    y = x.copy()
    for i, n in enumerate(nv):
        y[i, n:] = 0.3
    a = probust.scale_scan_plain(torch.from_numpy(x), torch.from_numpy(nv), b)
    c = probust.scale_scan_plain(torch.from_numpy(y), torch.from_numpy(nv), b)
    assert torch.equal(torch.isneginf(a), torch.isneginf(c))
    fin = torch.isfinite(a)
    assert float((a - c)[fin].abs().max()) <= 1e-5


def test_spectra_table_goes_with_its_bank(bank):
    spec = probust.scan_bank_spectra(bank)
    assert spec.shape == (124, 2049) and spec.dtype == np.complex64
    want = np.fft.rfft(bank.astype(np.float64), 4096, axis=-1)
    np.testing.assert_allclose(spec, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    dev = probust.device_scan_bank(bank, "cpu")
    assert torch.equal(dev, torch.from_numpy(bank))
    assert dev.scan_spectra.dtype == torch.complex64
    assert torch.equal(dev.scan_spectra, torch.from_numpy(spec))


def test_scan_refusals(bank):
    x = torch.zeros(2, 20_000)
    nv = torch.full((2,), 20_000)
    b = torch.from_numpy(bank)
    for args in ((x.double(), nv, b), (x, nv.float(), b), (x, nv, b.half()),
                 (x[0], nv, b), (x, nv[:1], b), (x[:, :500], nv, b),
                 (x, nv, torch.zeros(4, probust.SCAN_MAX_L + 1)),
                 (x, nv, torch.zeros(probust.SCAN_MAX_ROWS + 1, 8)),
                 (x.mT.contiguous().mT, nv, b),
                 (x, nv, b.to("meta")), (x.to("meta"), nv, b)):
        with pytest.raises(ValueError):
            probust._scale_scan_batch(*args)
