"""echoseal_torch device resampler vs scipy and vs echoseal_tpu's.

The contract is ``scipy.signal.resample_poly`` (float64) to 1e-5 relative
for any rational ratio, the cases being those of tests/test_resample.py;
the JAX resampler on the same rows is held to the same margin, and the
host plans (taps, offsets, ``s0``) are equal to the last bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from echoseal_torch.ops import resample as pr
from echoseal_tpu.ops import resample as jr
from torch_port_util import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def x3():
    rng = np.random.default_rng(11)
    return rng.standard_normal((3, 40_000)).astype(np.float32)


def _rel_err(y, ref):
    return float(np.abs(y[..., : ref.shape[-1]] - ref).max()
                 / np.abs(ref).max())


@pytest.mark.parametrize("up,down,k_taps", [
    (12_000, 11_640, 24), (12_000, 12_599, 25), (48_000, 49_488, 24),
    (1000, 1031, None), (160, 147, None), (128, 256, None), (160, 294, None)])
def test_resample_plan_equals_jax(up, down, k_taps):
    got = pr.resample_plan(up, down, k_taps)
    want = jr.resample_plan(up, down, k_taps)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
    assert pr.taps_needed(up, down) == jr.taps_needed(up, down)


@pytest.mark.parametrize("down", [45_600, 46_703, 48_001, 49_488, 50_400])
def test_family_parity_vs_scipy(x3, down):
    """One resampler covers the +-5% family at every ratio, non-coprime and
    near-1 ones included; the tail past ``n_out`` is exactly zero."""
    rs = pr.DeviceResampler(48_000, 45_600, 50_400, x3.shape[-1],
                            device="cpu")
    y, n_out = rs(torch.from_numpy(x3), down)
    y = y.numpy()
    ref = resample_poly(x3.astype(np.float64), 48_000, down, axis=-1)
    assert ref.shape[-1] == n_out
    assert y.shape == (3, rs.n_blocks * 48_000)
    assert _rel_err(y, ref) < 1e-5
    assert y.shape[-1] > n_out and np.abs(y[:, n_out:]).max() == 0.0


@pytest.mark.parametrize("down", [953, 1031])
def test_coarse_grid_lattice_parity_and_jax(x3, down):
    """The 1000-lattice (scan-grid factors), also against the JAX resampler."""
    rs = pr.DeviceResampler(1000, 950, 1050, x3.shape[-1], device="cpu")
    y, n_out = rs(torch.from_numpy(x3), down)
    ref = resample_poly(x3.astype(np.float64), 1000, down, axis=-1)
    assert _rel_err(y.numpy(), ref) < 1e-5
    jrs = jr.DeviceResampler(1000, 950, 1050, x3.shape[-1])
    jy, jn = jrs(jnp.asarray(x3), down)
    assert jn == n_out and (rs.n_blocks, rs.k_taps, rs.pad_left, rs.width) == (
        jrs.n_blocks, jrs.k_taps, jrs.pad_left, jrs.width)
    jy = np.asarray(jy)
    assert jy.shape == tuple(y.shape)
    assert np.abs(y.numpy() - jy).max() <= 1e-5 * np.abs(jy).max()


def test_ingest_ratio_and_1d():
    """44.1 kHz -> 48 kHz ingest (160/147) on a 1-D row."""
    x = np.random.default_rng(3).standard_normal(44_100).astype(np.float32)
    y = pr.resample_rows(torch.from_numpy(x), 160, 147).numpy()
    ref = resample_poly(x.astype(np.float64), 160, 147)
    assert y.shape == ref.shape
    assert _rel_err(y, ref) < 1e-5
    jy = np.asarray(jr.resample_rows(jnp.asarray(x), 160, 147))
    assert np.abs(y - jy).max() <= 1e-5 * np.abs(jy).max()


@pytest.mark.parametrize("up,down", [(1, 2), (160, 294), (128, 256)])
def test_downsampling_ratios(up, down):
    """Decimating ratios (96 kHz / 88.2 kHz captures) need more taps per
    phase than the +-5% family; the plan sizes them."""
    x = np.random.default_rng(4).standard_normal((2, 9_600)).astype(np.float32)
    y = pr.resample_rows(torch.from_numpy(x), up, down).numpy()
    ref = resample_poly(x.astype(np.float64), up, down, axis=-1)
    assert y.shape == ref.shape
    assert _rel_err(y, ref) < 1e-5


def test_bounded_temporary_path_parity(x3):
    """A small ``chunk_elems`` splits the rows into chunks (ragged last one
    included); the output equals the one-chunk output bit for bit."""
    one = pr.DeviceResampler(1000, 950, 1050, x3.shape[-1], device="cpu")
    # 80k elems / (42 blocks * 1000) -> 1 row per chunk
    many = pr.DeviceResampler(1000, 950, 1050, x3.shape[-1], device="cpu",
                              chunk_elems=80_000)
    two = pr.DeviceResampler(1000, 950, 1050, x3.shape[-1], device="cpu",
                             chunk_elems=2 * 42_000)
    ref = resample_poly(x3.astype(np.float64), 1000, 1031, axis=-1)
    y1, _ = one(torch.from_numpy(x3), 1031)
    for rs in (many, two):
        y, _ = rs(torch.from_numpy(x3), 1031)
        assert torch.equal(y, y1)
    assert _rel_err(y1.numpy(), ref) < 1e-5
    ys = pr.resample_rows(torch.from_numpy(x3[:2]), 1000, 1031,
                          chunk_elems=1).numpy()
    assert _rel_err(ys, ref[:2]) < 1e-5


def test_short_input_reads_zeros_outside():
    """Rows shorter than one block: negative ``s0`` and the blocks past the
    input read zeros, never wrap or clamp."""
    x = np.random.default_rng(5).standard_normal((2, 37)).astype(np.float32)
    for up, down in ((12_000, 11_400), (12_000, 12_600), (160, 147)):
        y = pr.resample_rows(torch.from_numpy(x), up, down).numpy()
        ref = resample_poly(x.astype(np.float64), up, down, axis=-1)
        assert y.shape == ref.shape
        assert _rel_err(y, ref) < 1e-5
    assert pr.resample_plan(12_000, 11_400)[2] < 0      # s0 is negative here


def test_contract_errors(x3):
    rs = pr.DeviceResampler(1000, 950, 1050, x3.shape[-1], device="cpu")
    xt = torch.from_numpy(x3)
    with pytest.raises(ValueError):
        rs(xt, 900)                         # outside the family
    with pytest.raises(ValueError):
        rs(xt[:, :100], 1031)               # wrong t_in
    with pytest.raises(ValueError):
        pr.resample_plan(1000, 1000)        # factor 1.0 is the identity
    with pytest.raises(ValueError):
        pr.resample_plan(1000, 1031, 4)     # too few taps
    with pytest.raises(ValueError):
        pr.DeviceResampler(1000, 1050, 950, 100, device="cpu")
    narrow = pr.DeviceResampler(1000, 950, 1050, x3.shape[-1], device="cpu")
    narrow.width = 10                       # a plan wider than the window
    with pytest.raises(ValueError, match="window"):
        narrow(xt, 1031)


def test_plan_cache_is_lru_capped(x3):
    rs = pr.DeviceResampler(1000, 950, 1050, 64, device="cpu")
    rs._plans_cap = 3
    x = torch.from_numpy(x3[:1, :64])
    for down in (951, 952, 953, 951, 954):
        rs(x, down)
    assert list(rs._plans) == [953, 951, 954]   # 952 evicted, 951 refreshed
    taps, off, s0 = rs._plans[951]
    assert taps.dtype == torch.float32 and taps.shape == (1000, rs.k_taps)
    assert rs._plan_dev(951)[0] is taps         # a hit uploads nothing new


def test_resample_to_equals_jax_host_helper():
    from echoseal_tpu.models.detector import resample_to as j_resample_to

    x = np.random.default_rng(6).standard_normal(5000).astype(np.float32)
    for fs_t, fs_in in ((48_000, 44_100), (48_000, 48_000), (46_602, 48_000)):
        np.testing.assert_array_equal(pr.resample_to(fs_t, x, fs_in),
                                      j_resample_to(fs_t, x, fs_in))


# ------------------------------------------- rows by index, kept width
def test_rows_and_width_select_and_trim(x3):
    """``rows`` (unordered, repeated) and ``width`` equal the whole
    resample's rows and columns bit for bit on the CPU."""
    rs = pr.DeviceResampler(1000, 950, 1050, x3.shape[-1], device="cpu")
    xt = torch.from_numpy(x3)
    whole, n_out = rs(xt, 1031)
    for rows, width in (([2, 0, 0], 40_000), ([1], n_out + 17),
                        (np.array([0, 2]), rs.n_blocks * 1000), ([], 500)):
        y, n = rs(xt, 1031, rows=rows, width=width)
        assert n == n_out and y.shape == (len(rows), width)
        assert torch.equal(y, whole[list(rows)][:, :width])
    y, _ = rs(xt, 1031, rows=torch.tensor([1, 1]), width=n_out + 17)
    assert np.abs(y[:, n_out:].numpy()).max() == 0.0


def _kernel_tiles(up, down, K):
    """``csrc/resample.cu``'s launcher: the tile (outputs a block), the
    lattice blocks a tile takes (m), the staged span of one item's input
    and the taps the loop runs over (K in whole slices of 28)."""
    kpad = -(-K // 28) * 28
    tile = min(256, (3200 - 6 - kpad) * up // down + 1)
    span = (-(-(tile - 1) * down // up) + kpad + 6) // 4 * 4
    return tile, (1 if up >= tile else tile // up), span, kpad


@pytest.mark.parametrize("up,down,T", [
    (12_000, 10_511, 30_000), (12_000, 13_642, 30_000), (160, 147, 3_000),
    (160, 294, 3_000), (1, 2, 1_000), (128, 256, 2_000), (12_000, 11_640, 37),
    (128, 1_024, 2_000), (140, 1_029, 2_000), (128, 2_048, 2_000),
    (1, 150, 2_000)])
def test_kernel_tiles_replay_plain(up, down, T):
    """Every output of a kernel tile reads inside the input run the kernel
    stages for the tile (the bound its launcher sizes the run by; the kernel
    answers a plan outside it with NaN), for every ratio family the port
    uses, the 384 and 768 kHz ingest lattices (K 164 and 324, the latter on
    a narrowed tile) and the widest decimation taken."""
    rs = pr.DeviceResampler(up, down, down, T, device="cpu")
    taps, off, s0 = pr.resample_plan(up, down, rs.k_taps)
    assert rs.k_taps <= pr.RESAMPLE_MAX_K
    tile, m, span, kpad = _kernel_tiles(up, down, rs.k_taps)
    assert 1 <= tile <= 256 and span <= 3200
    ups = m * up
    for s_first in range(0, ups, tile):
        s = np.arange(s_first, min(s_first + tile, ups))
        off_first = (s_first // up) * down + int(off[s_first % up])
        local = (s // up) * down + off[s % up] - off_first
        # the 16-byte copies start up to 3 samples before the run
        assert local.min() >= 0 and local.max() + 3 + kpad <= span


_REFUSALS = {
    "x_float64": lambda x, t, o: ((x.double(), None, t, o), {}),
    "taps_half": lambda x, t, o: ((x, None, t.half(), o), {}),
    "off_int64": lambda x, t, o: ((x, None, t, o.long()), {}),
    "x_1d": lambda x, t, o: ((x[0], None, t, o), {}),
    "no_taps": lambda x, t, o: ((x, None, t[:, :0], o), {}),
    "too_many_taps": lambda x, t, o: (
        (x, None, torch.zeros(1000, pr.RESAMPLE_MAX_K + 1), o), {}),
    "off_short": lambda x, t, o: ((x, None, t, o[:-1]), {}),
    "x_strided": lambda x, t, o: ((x.mT.contiguous().mT, None, t, o), {}),
    "taps_strided": lambda x, t, o: ((x, None, t.mT.contiguous().mT, o), {}),
    "row_past_end": lambda x, t, o: ((x, [0, 3], t, o), {}),
    "row_negative": lambda x, t, o: ((x, [-1], t, o), {}),
    "rows_2d": lambda x, t, o: ((x, [[0]], t, o), {}),
    "too_wide": lambda x, t, o: ((x, None, t, o), {"width": 3 * 1000 + 1}),
    "off_on_meta": lambda x, t, o: ((x, None, t, o.to("meta")), {}),
    "x_on_meta": lambda x, t, o: ((x.to("meta"), None, t, o), {}),
}


@pytest.mark.parametrize("case", list(_REFUSALS))
def test_resample_refusals(case):
    """``resample_batch`` refuses what the kernel does not take, on the CPU
    as on the card: dtypes, shapes, strides, rows out of range, devices."""
    rs = pr.DeviceResampler(1000, 950, 1050, 2_000, device="cpu")
    assert rs.n_blocks == 3
    taps, off, s0 = rs._plan_dev(1031)
    args, extra = _REFUSALS[case](torch.zeros(3, 2_000), taps, off)
    with pytest.raises(ValueError):
        pr.resample_batch(*args, s0, 1031, 1_940, n_blocks=rs.n_blocks,
                          **extra)


def test_resample_refuses_wide_decimation():
    """A decimation whose phases need more than RESAMPLE_MAX_K taps (160
    to 1: 3 204) is refused; a 13 to 1 one with few taps is taken."""
    y = pr.resample_batch(torch.zeros(1, 100), None, torch.zeros(1, 4),
                          torch.zeros(1, dtype=torch.int32), 0, 13, 7,
                          n_blocks=8)
    assert y.shape == (1, 8) and not y.any()
    rs = pr.DeviceResampler(1, 160, 160, 4_000, device="cpu")
    assert rs.k_taps > pr.RESAMPLE_MAX_K
    with pytest.raises(ValueError, match="taps"):
        rs(torch.zeros(1, 4_000), 160)
