"""The v2 batch sync: ``demod.sync_xcorr`` and its plain version, on the CPU.

``sync_xcorr_plain`` repeats the tile decomposition of
``csrc/sync_xcorr.cu`` in torch ops (GEMM rows of eight lags, a Toeplitz
template matrix, the energy as a ones band); here it is held to
``normalized_xcorr(..., torch.bfloat16)`` followed by the lag mask of the
batch stage.  The kernel itself is held to the plain version on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py`` phase 3e).  This file
imports neither JAX nor echoseal_tpu.
"""
import numpy as np
import pytest
import torch

from echoseal_torch.core.params import FRAME_LEN
from echoseal_torch.core.profiles import ROBUST
from echoseal_torch.models import pipeline, robust
from echoseal_torch.ops import build, demod
from torch_port_util import two_torch_threads  # noqa: F401

FS = 48_000
# max |plain - conv| over the unmasked lags, relative to the largest |corr|:
# both sum the same exact products in float32, in another order
REL_TOL = 1e-6


def _templates(L: int) -> torch.Tensor:
    """The v2 templates (L = 504) or the compat ones (L = 63)."""
    if L == 63:
        return torch.from_numpy(demod.sync_templates(FS))
    assert L == 63 * ROBUST.oversample
    return torch.from_numpy(robust.robust_templates(FS, ROBUST.oversample))


def _rows(B: int, T: int, L: int, span: int, seed: int):
    """(B, T) rows with a zero tail past each row's length, and lengths
    from one below a frame (row 0, all lags masked) to the full row."""
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((B, T))).astype(np.float32)
    nv = rng.integers(min(span, T), T + 1, B)
    nv[0] = span - 1
    for i, n in enumerate(nv):
        x[i, n:] = 0.0
    return torch.from_numpy(x), torch.from_numpy(nv.astype(np.int32))


def _conv_masked(x, tpl, nv, span):
    corr = demod.normalized_xcorr(x, tpl, compute_dtype=torch.bfloat16)
    lag = torch.arange(corr.shape[-1])
    return corr.masked_fill(lag > (nv[:, None, None] - span), float("-inf"))


# (L, span, B, T): the v2 templates against 2 L and against the v2 frame,
# the compat ones against the compat frame; T ragged against the 8-lag rows
# and the 2048-lag tiles, and T = L (one lag); B = 17 is one 16-row chunk of
# the plain version and one row more
CASES = [(504, 1008, 1, 10_007), (504, 1008, 3, 6_001), (504, 1008, 17, 2_345),
         (504, ROBUST.span, 3, 20_011), (504, 1008, 3, 504),
         (63, FRAME_LEN, 1, 3_001), (63, FRAME_LEN, 17, 4_099)]


@pytest.mark.parametrize("L,span,B,T", CASES,
                         ids=[f"L{c[0]}-span{c[1]}-B{c[2]}-T{c[3]}"
                              for c in CASES])
def test_plain_equals_bf16_conv_and_mask(L, span, B, T):
    tpl = _templates(L)
    x, nv = _rows(B, T, L, span, seed=B * T + L)
    got = demod.sync_xcorr_plain(x, tpl, nv, span)
    want = _conv_masked(x, tpl, nv, span)
    assert got.shape == want.shape == (B, 4, T - L + 1)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert torch.isneginf(got[0]).all()           # n_valid below span
    fin = torch.isfinite(want)
    assert torch.isfinite(got).eq(fin).all()
    if fin.any():
        err = float((got[fin] - want[fin]).abs().max())
        assert err <= REL_TOL * float(want[fin].abs().max()), err


@pytest.mark.parametrize("L", [63, 504])
def test_toeplitz_columns(L):
    tpl = _templates(L)
    toe = demod._sync_toeplitz(tpl)
    K = demod._sync_depth(L)
    assert K % 16 == 0 and L + demod.SYNC_LAGS_PER_ROW - 1 <= K < L + 23
    assert toe.shape == (K, 5, demod.SYNC_LAGS_PER_ROW)
    tb = tpl.to(torch.bfloat16).to(torch.float32)
    for r in range(demod.SYNC_LAGS_PER_ROW):
        col = toe[:, :, r]                         # (K, 5)
        assert torch.equal(col[r:r + L, :4], tb.T)
        assert not col[:r].any() and not col[r + L:].any()
        assert torch.equal(col[r:r + L, 4], torch.ones(L))


def test_max_len_covers_v2_templates():
    assert demod.SYNC_MAX_L >= 63 * ROBUST.oversample
    assert demod._sync_depth(demod.SYNC_MAX_L) == 16 * demod.SYNC_MAX_STEPS


def test_wrapper_cpu_takes_plain_version(monkeypatch):
    tpl = _templates(504)
    x, nv = _rows(2, 3_000, 504, 1008, seed=2)
    seen = []
    plain = demod.sync_xcorr_plain
    monkeypatch.setattr(demod, "sync_xcorr_plain",
                        lambda *a, **k: seen.append(1) or plain(*a, **k))
    before = build.LAUNCHES["sync_xcorr"]
    out = demod.sync_xcorr(x, tpl, nv, 1008)
    assert seen == [1] and build.LAUNCHES["sync_xcorr"] == before
    assert torch.equal(out, plain(x, tpl, nv, 1008))


def test_wrapper_rejects_other_devices():
    tpl = torch.zeros(4, 504, device="meta")
    nv = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        demod.sync_xcorr(torch.zeros(2, 3000, device="meta"), tpl, nv, 1008)
    with pytest.raises(ValueError):
        demod.sync_xcorr(torch.zeros(2, 3000), tpl, nv, 1008)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, None],
                         ids=["bf16", "f32", "none"])
def test_sync_stage_routes_by_dtype(monkeypatch, dtype):
    """bf16 takes ``sync_xcorr`` (its plain version on the CPU) and no
    conv1d; every float32 sync takes ``normalized_xcorr`` and never the
    new function."""
    tpl = _templates(504)
    x, nv = _rows(3, 6_000, 504, 1008, seed=3)
    calls = []
    for name in ("sync_xcorr", "sync_xcorr_plain", "normalized_xcorr"):
        real = getattr(demod, name)
        monkeypatch.setattr(
            demod, name,
            lambda *a, _n=name, _f=real, **k: calls.append(_n) or _f(*a, **k))
    idx, val = pipeline._sync_stage(x, nv, tpl, 4, 1008, compute_dtype=dtype)
    if dtype is torch.bfloat16:
        assert calls == ["sync_xcorr", "sync_xcorr_plain"]
        corr = _conv_masked(x, tpl, nv, 1008)
    else:
        assert calls == ["normalized_xcorr"]
        corr = demod.normalized_xcorr(x, tpl, compute_dtype=dtype)
        lag = torch.arange(corr.shape[-1])
        corr = corr.masked_fill(lag > (nv[:, None, None] - 1008),
                                float("-inf"))
    want_idx, want_val = demod.topk_nms(corr, 4, 504)
    assert torch.equal(torch.isneginf(val), torch.isneginf(want_val))
    fin = torch.isfinite(want_val)
    assert torch.equal(idx[fin], want_idx[fin])
    torch.testing.assert_close(val[fin], want_val[fin], rtol=0, atol=1e-6)
