"""echoseal_torch's CUDA kernels and their wrappers, without JAX.

This file imports neither JAX nor echoseal_tpu, so it also runs where only
torch is installed.  On a machine with a card (which has no JAX, and so
cannot load tests/conftest.py), run it as

    python -m pytest --noconftest tests/test_torch_kernels.py

The kernel tests skip without a CUDA device: a CUDA kernel has no CPU mode.
The plain versions they are held against are themselves held against the
JAX package in tests/test_torch_demod.py, tests/test_torch_payload_decode.py,
tests/test_torch_scan.py and (the SCL list decoder's eager walk)
tests/test_torch_scl.py.
"""
import numpy as np
import pytest
import torch

from echoseal_torch.core.params import FRAME_LEN, HDR_L, PRE_L
from echoseal_torch.core.profiles import ROBUST, polar_spec_standard, \
    profile_spec
from echoseal_torch.ops import build, demod, llr, polar, scl

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
    assert build.sources() == ["payload_decode", "payload_llr", "resample",
                               "scale_scan", "scl_decode", "sync_xcorr"]
    assert build.library_path("payload_llr").name.startswith("libpayload_llr-")
    assert build.library_path("payload_decode").name.startswith(
        "libpayload_decode-")
    assert build.library_path("scl_decode").name.startswith("libscl_decode-")
    assert build.library_path("sync_xcorr").name.startswith("libsync_xcorr-")
    assert build.library_path("scale_scan").name.startswith("libscale_scan-")
    assert build.library_path("resample").name.startswith("libresample-")


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


# ------------------------------------------------------------ SCL decoder
SCL_SPECS = {"compat": polar.polar_spec, "v2": lambda: profile_spec(ROBUST)}


def _scl_rows(spec, n, seed=0):
    """(n, N) float32 LLRs of ``spec``'s codewords: noisy rows at sigma
    0.35 (the decoders' waterfall), then a noiseless one and an all-zero
    one, clipped to the pipeline's +-16."""
    rng = np.random.default_rng(seed)
    bits = np.stack([polar.encode_np(rng.bytes(spec.info_len // 8), spec)
                     for _ in range(n)])
    sigma = np.full((n, 1), 0.35)
    sigma[-2] = 1e-3
    y = (2.0 * bits - 1.0) + sigma * rng.standard_normal(bits.shape)
    out = np.clip(2.0 * y / sigma ** 2, -16.0, 16.0).astype(np.float32)
    out[-1] = 0.0
    return out


def _lists(info, ok, metric):
    return {"info_bits": torch.as_tensor(info, dtype=torch.int32),
            "crc_ok": torch.as_tensor(ok), "metrics": torch.as_tensor(
                metric, dtype=torch.float32)}


def test_scl_list_agreement_counts():
    """The contract's counts: a swap beside a near-equal metric is a tie,
    one elsewhere a mismatch; CRC-passing sets and first passing paths."""
    info = np.zeros((1, 4, 8), np.int32)
    info[0, :, 0] = [0, 1, 0, 1]
    info[0, :, 1] = [0, 0, 1, 1]
    want = _lists(info, [[False, True, True, False]], [[1.0, 2.0, 2.00001,
                                                        5.0]])
    assert scl.list_agreement(want, want)["holds"]
    swap = _lists(info[:, [0, 2, 1, 3]], [[False, True, True, False]],
                  [[1.0, 2.00001, 2.0, 5.0]])
    got = scl.list_agreement(swap, want)
    assert (got["ties"], got["mismatched"]) == (2, 0)
    assert got["sets_equal"] and not got["first_pass_equal"]
    far = _lists(info[:, [3, 1, 2, 0]], [[False, True, True, False]],
                 [[1.0, 2.0, 2.00001, 5.0]])
    got = scl.list_agreement(far, want)
    assert (got["ties"], got["mismatched"]) == (0, 2)
    assert not got["holds"]
    lost = _lists(info, [[False, True, False, False]],
                  [[1.0, 2.0, 2.00001, 5.0]])
    assert not scl.list_agreement(lost, want)["sets_equal"]


def test_scl_trace_stamps_the_kernel_source():
    """``tools/scl_trace.py`` finds its anchors in ``scl_decode.cu``: a
    stamp at every node op and one before the final lists, and the serving
    node's phase stamps (rank pass, forks in registers or through memory,
    partial sums)."""
    from echoseal_torch.tools import scl_trace

    src = (build.CSRC / "scl_decode.cu").read_text()
    traced = scl_trace.traced_source(src)
    assert traced.count("g_stamp[") == 3            # declaration + 2 stamps
    assert "scl_trace_read" in traced and "scl_trace_read" not in src
    assert traced.count("g_node[") == 5             # declaration + 4 stamps
    assert "scl_trace_node" in traced
    with pytest.raises(RuntimeError, match="anchor"):
        scl_trace.traced_source(src.replace("int P2 = pow2_at_least(L)",
                                            "int P2 = L"))


def test_scl_op_words_checked():
    """Op words handed to the kernel are checked on the host: both specs'
    schedules pass, a level or code the kernel cannot follow raises."""
    cpu = torch.device("cpu")
    for make in SCL_SPECS.values():
        scl._check_ops(torch.from_numpy(scl.node_schedule(make())), cpu, 10)
    for word in (scl._op(scl.OP_G, 10, 0), scl._op(scl.OP_RATE0, 11, 1),
                 scl._op(scl.OP_COMB + 1, 3, 0), 1 << 9, -1):
        with pytest.raises(ValueError, match="out of range"):
            scl._check_ops(torch.tensor([word], dtype=torch.int32), cpu, 10)
    with pytest.raises(ValueError, match="int32"):
        scl._check_ops(torch.zeros(2, dtype=torch.int64), cpu, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 8, 32, 256])
@pytest.mark.parametrize("spec_name", list(SCL_SPECS))
def test_scl_decode_kernel_on_card(spec_name, L):
    """The SCL kernel against the eager walk on the card, on noisy,
    noiseless and zero-LLR rows: per row the same CRC-passing payloads and
    first passing path, sorted metrics within rtol = atol = 1e-4 (the
    walk's node sums are torch reductions, the kernel's run in index
    order), and the lists path for path except beside a near-equal
    metric.  One launch per call; ``scl_decode`` routes a CUDA tensor to
    it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    spec = SCL_SPECS[spec_name]()
    x = torch.from_numpy(_scl_rows(spec, 8, seed=L)).cuda()
    before = build.LAUNCHES["scl_decode"]
    got = scl.scl_decode_kernel(x, spec, L)
    torch.cuda.synchronize()
    assert build.LAUNCHES["scl_decode"] == before + 1
    want = scl._scl_decode_plain(x, spec, L)
    agree = scl.list_agreement(got, want)
    assert agree["holds"], agree
    assert got["info_bits"].shape == (8, L, spec.info_len)
    assert got["crc_ok"][-2, 0]                      # the noiseless row
    routed = scl.scl_decode(x, spec, L)
    assert build.LAUNCHES["scl_decode"] == before + 2
    for k in got:
        assert torch.equal(routed[k], got[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,L,rows", [
    (16, 16, 3, 40), (64, 40, 5, 40), (512, 256, 37, 40),
    (1024, 448, 129, 24), (1024, 448, 32, 700), (1024, 448, 256, 300)],
    ids=["N16-rate1-L3", "N64-L5", "N512-L37", "N1024-L129", "rows700-L32",
         "rows300-L256"])
def test_scl_decode_kernel_other_shapes_on_card(N, K, L, rows):
    """Other code lengths, list sizes that are no power of two, and more
    rows than the card holds blocks at once (the grid strides over them):
    the same contract against the eager walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    spec = polar.polar_spec(N=N, K=K)
    x = torch.from_numpy(_scl_rows(spec, rows, seed=N + L)).cuda()
    got = scl.scl_decode_kernel(x, spec, L)
    torch.cuda.synchronize()
    agree = scl.list_agreement(got, scl._scl_decode_plain(x, spec, L))
    assert agree["holds"], agree
    assert got["crc_ok"][-2, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("which,L,rows", [
    ("compat", 1, 13), ("v2", 3, 7), ("v2", 8, 13), ("compat", 16, 10),
    ("v2", 17, 9), ("compat", 33, 5), ("compat", 256, 32),
    ("compat", 256, 1), ("compat", 512, 4), ("compat", 1024, 3),
    ("compat", 2048, 2)],
    ids=["L1-rows13", "L3-rows7", "L8-rows13", "L16-rows10", "L17-rows9",
         "L33-rows5", "L256-rows32", "L256-rows1", "L512-rows4",
         "L1024-rows3", "L2048-rows2"])
def test_scl_decode_kernel_plans_on_card(which, L, rows):
    """The kernel's own plans against the eager walk: one-warp rows four to
    a block at L <= 16 and two-warp rows two to a block at L 17-32, with
    row counts that leave a block part-filled; L = 33, the first one-block
    list; a compat single clip's 32 rows and one row at L = 256, fewer rows
    than SMs; and 16-bit path maps at L = 512 and 1024, which the wide
    alpha levels' device scratch serves, and at L = 2048, where a thread
    takes two paths and four keys and the metrics, keys and maps move to
    device scratch too.  The same contract, with the noiseless and zero-LLR
    rows among the rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    spec = SCL_SPECS[which]()
    x = torch.from_numpy(_scl_rows(spec, max(rows, 2), seed=L + rows)).cuda()
    x = x[-rows:].contiguous()
    plan = scl.kernel_plan(spec.N, L, rows)
    assert plan["threads_per_row"] == (
        32 if L <= 16 else 64 if L <= 32 else 1024 if L > 256
        else min(512, 1 << (4 * L - 1).bit_length()))
    assert plan["rows_per_block"] == min(rows, 128 // plan["threads_per_row"]
                                         if L <= 32 else 1)
    got = scl.scl_decode_kernel(x, spec, L)
    torch.cuda.synchronize()
    agree = scl.list_agreement(got, scl._scl_decode_plain(x, spec, L))
    assert agree["holds"], agree
    assert got["info_bits"].shape == (rows, L, spec.info_len)
    if rows >= 2:
        assert got["crc_ok"][-2, 0]                  # the noiseless row


@pytest.mark.cuda
def test_scl_decode_routes_list_sizes_on_card():
    """On the card ``scl_decode`` decodes L = 512 and L = 1025 (past the
    old byte maps and a 1024-thread block's one path a thread) each in one
    launch of the kernel, which holds the contract against the walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    spec = polar.polar_spec()
    x = torch.from_numpy(_scl_rows(spec, 2, seed=5)).cuda()
    for L in (512, 1025):
        launches = build.LAUNCHES["scl_decode"]
        got = scl.scl_decode(x, spec, L)
        torch.cuda.synchronize()
        assert build.LAUNCHES["scl_decode"] == launches + 1
        assert got["info_bits"].shape == (2, L, spec.info_len)
        agree = scl.list_agreement(got, scl._scl_decode_plain(x, spec, L))
        assert agree["holds"], (L, agree)
        assert got["crc_ok"][0, 0]                   # the noiseless row


@pytest.mark.cuda
def test_scl_decode_refusals_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    spec = polar.polar_spec()
    x = torch.from_numpy(_scl_rows(spec, 4)).cuda()
    before = build.LAUNCHES["scl_decode"]
    for args in ((x.cpu(), spec, 8),                    # not on the card
                 (x.double(), spec, 8),                 # float64
                 (x.mT.contiguous().mT, spec, 8),       # column-major
                 (x[:, :512], spec, 8),                 # width
                 (x, spec, 0), (x, spec, 65537)):       # list size
        with pytest.raises(ValueError):
            scl.scl_decode_kernel(*args)
    with pytest.raises(ValueError):                     # the ops' device
        scl.scl_decode_kernel(x, spec, 8,
                              ops=torch.from_numpy(scl.node_schedule(spec)))
    for word in (scl._op(scl.OP_F, 10, 0), scl._op(scl.OP_LEAF, 11, 0),
                 scl._op(scl.OP_COMB + 1, 3, 0), -1):   # a level or code
        with pytest.raises(ValueError, match="out of range"):
            scl.scl_decode_kernel(x, spec, 8, ops=torch.tensor(
                [word], dtype=torch.int32, device="cuda"))
    assert build.LAUNCHES["scl_decode"] == before
    empty = scl.scl_decode_kernel(x[:0], spec, 8)
    assert empty["info_bits"].shape == (0, 8, spec.info_len)
    assert build.LAUNCHES["scl_decode"] == before


# ------------------------------------------------- SCL serving decoder
@pytest.mark.cuda
@pytest.mark.parametrize("block_seg", [8, 16, 64])
@pytest.mark.parametrize("L", [1, 8, 32, 256])
@pytest.mark.parametrize("spec_name", list(SCL_SPECS))
def test_scl_serving_kernel_on_card(spec_name, L, block_seg):
    """The serving kernel against the eager serving walk on the card, on
    noisy, noiseless and zero-LLR rows, at 16-, 32- and 128-leaf nodes (the
    last ranked through memory): the exact kernel's contract
    (``list_agreement``), one launch per call, none of the exact kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    spec = SCL_SPECS[spec_name]()
    x = torch.from_numpy(_scl_rows(spec, 8, seed=L + block_seg)).cuda()
    before = dict(build.LAUNCHES)
    got = scl.scl_decode_serving_kernel(x, spec, L, block_seg)
    torch.cuda.synchronize()
    assert build.LAUNCHES["scl_serving"] == before.get("scl_serving", 0) + 1
    assert build.LAUNCHES["scl_decode"] == before.get("scl_decode", 0)
    want = scl._walk_decode(x, spec, L, serving=True, block_seg=block_seg)
    agree = scl.list_agreement(got, want)
    assert agree["holds"], agree
    assert got["info_bits"].shape == (8, L, spec.info_len)
    assert got["crc_ok"][-2, 0] and got["metrics"][-2, 0] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("block_seg", [8, 16, 64])
@pytest.mark.parametrize("L", [1, 2, 4, 8, 16, 32, 64])
def test_scl_serving_node_forks_on_card(L, block_seg):
    """The node ops' fork schemes against the serving walk: forks in one
    warp's registers at L <= 32 (one-warp rows to L = 16, two-warp rows at
    32), through memory at 64; flip words over the ranks at 16-, 32- and
    128-leaf nodes.  Seven rows leave a block part-filled (four or two
    rows a block); the all-zero row, where every fork is a tie, must give
    the walk's lists exactly, its order the candidates' indices."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    spec = SCL_SPECS["v2" if block_seg == 16 else "compat"]()
    x = torch.from_numpy(_scl_rows(spec, 7, seed=7 * L + block_seg)).cuda()
    got = scl.scl_decode_serving_kernel(x, spec, L, block_seg)
    torch.cuda.synchronize()
    want = scl._walk_decode(x, spec, L, serving=True, block_seg=block_seg)
    agree = scl.list_agreement(got, want)
    assert agree["holds"], agree
    assert got["crc_ok"][-2, 0] and got["metrics"][-2, 0] == 0.0
    for k in got:
        assert torch.equal(got[k][-1].cpu(), want[k][-1].cpu()), k


@pytest.mark.cuda
@pytest.mark.parametrize("entry,env", [
    ("scl_decode", {"IMPL": "serving"}),
    ("scl_decode", {"IMPL": "serving", "BLOCK_SEG": "8"}),
    ("scl_decode_serving", {"SERVING": "1"}),
    ("scl_decode_serving", {"SERVING": "1", "BLOCK_SEG": "64"})])
def test_scl_serving_routes_on_card(monkeypatch, entry, env):
    """``ECHOSEAL_SCL_IMPL=serving`` and ``ECHOSEAL_SCL_SERVING`` put a card
    tensor's decode on one launch of the serving kernel at the switches'
    ``block_seg``, the same lists as the kernel called directly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for name in ("ECHOSEAL_SCL_IMPL", "ECHOSEAL_SCL_SERVING",
                 "ECHOSEAL_SCL_BLOCK_SEG"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(f"ECHOSEAL_SCL_{k}", v)
    spec = SCL_SPECS["v2"]()
    x = torch.from_numpy(_scl_rows(spec, 6, seed=3)).cuda()
    want = scl.scl_decode_serving_kernel(x, spec, 8,
                                         int(env.get("BLOCK_SEG", 16)))
    before = dict(build.LAUNCHES)
    got = getattr(scl, entry)(x, spec, 8)
    torch.cuda.synchronize()
    assert build.LAUNCHES["scl_serving"] == before["scl_serving"] + 1
    assert build.LAUNCHES["scl_decode"] == before.get("scl_decode", 0)
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("L,block_seg", [(1025, 16), (2048, 64)])
def test_scl_serving_large_lists_on_card(L, block_seg):
    """Lists past 1024 paths: a thread takes several paths and keys, and at
    L = 2048 the row's state with the node ops' ranks and masks lives in
    device scratch.  The contract against the walk holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    spec = polar.polar_spec()
    x = torch.from_numpy(_scl_rows(spec, 2, seed=L)).cuda()
    got = scl.scl_decode_serving_kernel(x, spec, L, block_seg)
    torch.cuda.synchronize()
    agree = scl.list_agreement(got, scl._walk_decode(
        x, spec, L, serving=True, block_seg=block_seg))
    assert agree["holds"], (L, agree)
    assert got["crc_ok"][0, 0]                       # the noiseless row


@pytest.mark.cuda
def test_scl_serving_refusals_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    spec = polar.polar_spec()
    x = torch.from_numpy(_scl_rows(spec, 4)).cuda()
    before = dict(build.LAUNCHES)
    for args in ((x.cpu(), spec, 8),                    # not on the card
                 (x.double(), spec, 8),                 # float64
                 (x.mT.contiguous().mT, spec, 8),       # column-major
                 (x[:, :512], spec, 8),                 # width
                 (x, spec, 0), (x, spec, 65537),        # list size
                 (x, spec, 8, 0), (x, spec, 8, 2.5)):   # block_seg
        with pytest.raises(ValueError):
            scl.scl_decode_serving_kernel(*args)
    with pytest.raises(ValueError):                     # the ops' device
        scl.scl_decode_serving_kernel(
            x, spec, 8, ops=torch.from_numpy(scl.serving_schedule(spec, 16)))
    for word in (scl._op(scl.OP_RATE1, 0, 0), scl._op(scl.OP_SPC, 10, 0),
                 scl._op(scl.OP_SPC + 1, 3, 0), -1):    # a level or code
        with pytest.raises(ValueError, match="out of range"):
            scl.scl_decode_serving_kernel(x, spec, 8, ops=torch.tensor(
                [word], dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="out of range"):   # exact: no nodes
        scl.scl_decode_kernel(x, spec, 8, ops=torch.from_numpy(
            scl.serving_schedule(spec, 16)).cuda())
    assert dict(build.LAUNCHES) == before
    empty = scl.scl_decode_serving_kernel(x[:0], spec, 8)
    assert empty["info_bits"].shape == (0, 8, spec.info_len)
    assert dict(build.LAUNCHES) == before


# (rows, T, span, n_valid dtype): one row; rows ragged against the kernel's
# 2048-lag tiles with a row below a frame; the v2 stage's frame and T = L
SYNC_SHAPES = [(1, 20_011, 9_720, torch.int32), (7, 12_345, 1_008, torch.int64),
               (3, 30_001, 9_720, torch.int32), (2, 504, 1_008, torch.int32)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,T,span,nv_dtype", SYNC_SHAPES)
def test_sync_xcorr_kernel_on_card(rows, T, span, nv_dtype):
    """The v2 sync kernel against its plain version on the card: corr
    within 1e-5 (the same exact products, summed in another order), -inf
    at exactly the lags past ``n_valid - span``; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from echoseal_torch.models import robust

    tpl = torch.from_numpy(robust.robust_templates(48_000, 8)).cuda()
    rng = np.random.default_rng(rows * T)
    x = torch.from_numpy((0.1 * rng.standard_normal((rows, T))
                          ).astype(np.float32)).cuda()
    nv = torch.from_numpy(rng.integers(min(span, T), T + 1, rows)).to(
        device="cuda", dtype=nv_dtype)
    nv[0] = span - 1 if rows > 1 else nv[0]
    before = build.LAUNCHES["sync_xcorr"]
    got = demod.sync_xcorr(x, tpl, nv, span)
    torch.cuda.synchronize()
    assert build.LAUNCHES["sync_xcorr"] == before + 1
    want = demod.sync_xcorr_plain(x, tpl, nv, span)
    lag = torch.arange(T - 503, device="cuda")
    bad = (lag > (nv.long()[:, None] - span))[:, None, :].expand_as(got)
    assert torch.equal(torch.isneginf(got), bad)
    if (~bad).any():
        assert float((got - want)[~bad].abs().max()) <= 1e-5


@pytest.mark.cuda
def test_sync_xcorr_refuses_long_templates():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x = torch.zeros(2, 4096, device="cuda")
    nv = torch.full((2,), 4096, dtype=torch.int32, device="cuda")
    tpl = torch.zeros(4, demod.SYNC_MAX_L + 1, device="cuda")
    with pytest.raises(ValueError, match="shapes"):
        demod.sync_xcorr(x, tpl, nv, 1008)
    with pytest.raises(ValueError, match="shapes"):
        demod.sync_xcorr(x[:, :100], tpl[:, :200], nv, 1008)


def _scan_rows(rows, T, seed):
    """``rows`` rows of noise carrying three bank rows each, and ragged
    lengths: the recovery's 3.5 s cuts, one a segment and a half long, one
    below the bank's width, one at it, one past T."""
    from echoseal_torch.models import robust

    bank = robust.scaled_template_bank(48_000, 8)
    R, L = bank.shape
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((rows, T))).astype(np.float32)
    for i in range(rows):
        for _ in range(3):
            s = int(rng.integers(0, T - L))
            x[i, s:s + L] += 0.5 * bank[int(rng.integers(0, R))]
    nv = np.full(rows, min(168_000, T), np.int64)
    H = robust.SCAN_FFT_LEN - L + 1
    nv[1:5] = (H + H // 2, L - 1, L, T + 7)[:max(rows - 1, 0)]
    return (torch.from_numpy(x).cuda(), torch.from_numpy(nv).cuda(),
            robust.device_scan_bank(bank, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,T", [(128, 184_384), (1, 1 << 18), (5, 9_000)])
def test_scale_scan_kernel_on_card(rows, T):
    """The scan kernel against its plain version on the card: the
    recovery's chunk of 128 rows of 184 384 samples, the single-clip
    stage's one padded row, short ragged rows.  Scores within 1e-5, -inf
    exactly where the plain version has it; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from echoseal_torch.models import robust

    x, nv, bank = _scan_rows(rows, T, rows)
    before = build.LAUNCHES["scale_scan"]
    got = robust._scale_scan_batch(x, nv, bank)
    torch.cuda.synchronize()
    assert build.LAUNCHES["scale_scan"] == before + 1
    assert got.shape == (rows, bank.shape[0]) and got.dtype == torch.float32
    want = robust.scale_scan_plain(x, nv, bank)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert not torch.isnan(got).any()
    fin = torch.isfinite(want)
    if fin.any():
        assert float((got - want)[fin].abs().max()) <= 1e-5
    one = robust._scale_scan_stage(x[0], int(nv[0]), bank)
    assert build.LAUNCHES["scale_scan"] == before + 2
    assert torch.equal(one, got[0])


@pytest.mark.cuda
def test_scale_scan_refusals_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from echoseal_torch.models import robust

    x, nv, bank = _scan_rows(2, 20_000, 0)
    before = dict(build.LAUNCHES)
    for args in ((x.cpu(), nv, bank), (x, nv.cpu(), bank),
                 (x, nv, bank.cpu()), (x.double(), nv, bank),
                 (x, nv.float(), bank), (x, nv, bank.half()),
                 (x, nv, torch.zeros(4, robust.SCAN_MAX_L + 1,
                                     device="cuda")),
                 (x, nv, bank.clone())):       # no spectra table
        with pytest.raises(ValueError):
            robust._scale_scan_batch(*args)
    assert dict(build.LAUNCHES) == before


def _retry_family(T):
    """The recovery's device resampler family (``_device_resampler``)."""
    from echoseal_torch.models.pipeline import RobustBatchVerifier as V
    from echoseal_torch.ops.resample import DeviceResampler

    lo, hi = V.RETRY_REACH
    return DeviceResampler(V.RETRY_UP, int(V.RETRY_UP * lo) - 4,
                           int(V.RETRY_UP * hi) + 4, T, device="cuda")


# (up, down, T, rows): the recovery lattice's reach at its clip width, the
# ingest ratios (96, 352.8, 384 and 768 kHz as ``_ingest`` lays them out:
# K 44, 151, 164 and 324, the last on a narrowed tile), one row, rows not a
# multiple of a stage's eight items, unordered and repeated rows, inputs
# shorter than one lattice block
RESAMPLE_CASES = [
    *[(12_000, d, 184_384, [5, 0, 3, 3, 1, 6, 2])
      for d in (10_511, 11_639, 11_640, 12_599, 13_642)],
    (12_000, 11_640, 184_384, [4]),
    (160, 147, 154_350, [2, 0, 1]),
    (1, 2, 9_600, [1, 1, 0]),
    (160, 294, 9_600, [0, 1]),
    (128, 256, 9_600, [1, 0]),
    (140, 1_029, 70_560, [0, 2, 2]),
    (128, 1_024, 76_800, [1, 0]),
    (128, 2_048, 76_800, [1]),
    (12_000, 12_599, 37, [1, 0, 1]),
    (160, 147, 37, [0]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("up,down,T,rows", RESAMPLE_CASES)
def test_resample_kernel_on_card(up, down, T, rows):
    """The resample kernel against its plain version on the card and
    against float64 ``scipy.signal.resample_poly``, 1e-5 relative; zeros
    past ``n_out`` within the kept width; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from scipy.signal import resample_poly

    from echoseal_torch.ops import resample as pr

    rng = np.random.default_rng(up + down + T)
    x = torch.from_numpy(rng.standard_normal((8, T)).astype(np.float32))
    rs = (_retry_family(T) if up == 12_000 and T > 1_000
          else pr.DeviceResampler(up, down, down, T, device="cuda"))
    width = min(T, rs.n_blocks * up) if T > 1_000 else rs.n_blocks * up
    xd = x.cuda()
    before = build.LAUNCHES["resample"]
    got, n_out = rs(xd, down, rows=rows, width=width)
    torch.cuda.synchronize()
    assert build.LAUNCHES["resample"] == before + 1
    assert got.shape == (len(rows), width) and got.is_contiguous()
    taps, off, s0 = rs._plan_dev(down)
    keep = min(n_out, width)
    plain = pr._resample_stage(
        xd[torch.tensor(rows, device="cuda")], taps, off, s0, down,
        min(n_out, rs.n_blocks * up), n_blocks=rs.n_blocks,
        pad_left=rs.pad_left)[:, :width]
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= 1e-5 * scale
    ref = resample_poly(x.numpy()[rows].astype(np.float64), up, down,
                        axis=-1)
    assert ref.shape[-1] == n_out
    g = got.cpu().numpy()
    assert np.abs(g[:, :keep] - ref[:, :keep]).max() <= \
        1e-5 * np.abs(ref).max()
    assert np.abs(g[:, keep:]).max(initial=0.0) == 0.0


@pytest.mark.cuda
def test_resample_kernel_alone_on_card():
    """A resample on the card launches the kernel and nothing else: no
    gather, multiply-add, pad, copy or fill of its own."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rs = _retry_family(184_384)
    x = torch.randn(16, 184_384, device="cuda")
    rs(x, 11_640, rows=[3, 1], width=184_384)         # plan, library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for den in (11_640, 11_639):
            rs(x, den, rows=list(range(0, 16, 2)), width=184_384)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("Memcpy")]
    assert kernels and all("resample_kernel" in k for k in kernels), kernels


@pytest.mark.cuda
def test_resample_refusals_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from echoseal_torch.ops import resample as pr

    rs = pr.DeviceResampler(1000, 950, 1050, 2_000, device="cuda")
    taps, off, s0 = rs._plan_dev(1031)
    x = torch.zeros(3, 2_000, device="cuda")
    before = dict(build.LAUNCHES)
    for args in ((x.cpu(), None, taps, off), (x, None, taps.cpu(), off),
                 (x, None, taps, off.cpu()), (x.double(), None, taps, off),
                 (x, None, taps, off.long()),
                 (x, torch.tensor([0], device="cuda"), taps, off),
                 (x, [0, 3], taps, off), (x, [-1], taps, off),
                 (x[:, ::2], None, taps, off)):
        with pytest.raises(ValueError):
            pr.resample_batch(*args, s0, 1031, 1_940, n_blocks=rs.n_blocks)
    assert dict(build.LAUNCHES) == before


@pytest.mark.cuda
def test_resample_kernel_unaligned_rows_on_card():
    """Rows that do not start on a 16-byte boundary (a view one sample in)
    take the kernel's 4-byte copies and give the same outputs, bit for
    bit, as the aligned rows' 16-byte copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    T = 184_384
    rs = _retry_family(T)
    wide = torch.randn(6, T + 1, device="cuda")
    view = wide[:, 1:]
    assert view.data_ptr() % 16 != 0
    before = build.LAUNCHES["resample"]
    got, _ = rs(view, 12_599, rows=[5, 2, 2], width=T)
    want, _ = rs(view.contiguous(), 12_599, rows=[5, 2, 2], width=T)
    torch.cuda.synchronize()
    assert build.LAUNCHES["resample"] == before + 2
    assert torch.equal(got, want)
