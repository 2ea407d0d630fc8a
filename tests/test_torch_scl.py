"""echoseal_torch's SCL list decoder vs echoseal_tpu's dense oracle, on the CPU.

``_scl_decode_dense`` is the JAX package's direct transcription of the
list-decode recursion, kept as the oracle for its production decoders
(tests/test_scl_proof.py).  The port's one exact decoder is held against it
on both specs (compat ``polar_spec()`` and the v2 ``profile_spec(ROBUST)``,
whose info set has the repetition subtrees) with the same inputs: sorted
metrics within rtol 1e-4 / atol 1e-3 (the shortcuts sum penalties in
another order), and the identical set of CRC-passing payloads.

On a CUDA tensor the exact decode is one launch of ``csrc/scl_decode.cu``,
which follows ``scl.node_schedule(spec)``.  A CUDA kernel has no CPU mode,
so here the schedule is replayed by the kernel's own scheme (slots written
for all paths at once, per-path source indices permuted at each fork, the
root's partial sums transformed back to the decisions) in torch ops, and
must give the eager walk's and the dense oracle's lists; the kernel itself
is held against the walk on the card (tests/test_torch_kernels.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echoseal_torch.core import profiles as pprof
from echoseal_torch.ops import build
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


def _replay(llr, spec, L):
    """``node_schedule(spec)`` run as scl_decode.cu runs it, in torch ops.

    Slot l holds alpha of level l (slot 0 is the LLR row), slot
    n + 1 + 2l + s the partial sums of (level l, side s); an op writes its
    slot for every path (path p's buffer at p, its index reset to p).  A
    fork gathers by the survivors' parents only the index columns the
    kernel keeps live: for each level l above the fork, alpha l while the
    walk is in the left child of its level-l node (``dir`` bit l clear; an
    f sets it so, a g the other way), else the left child's sums of level
    l + 1.  Every other slot keeps a stale column until it is written, so a
    slot read after a fork that this rule missed gives other lists.
    ``near_tie`` marks the rows where some fork kept one of two live
    candidates whose metrics differ, but by less than the metric tolerance
    (another float32 order of summation may keep the other).
    """
    B, N = llr.shape
    n = N.bit_length() - 1
    rows = torch.arange(B)[:, None]
    ident = torch.arange(L).expand(B, L)
    metric = torch.full((B, L), pscl.BIG_METRIC)
    metric[:, 0] = 0.0
    buf, src = {0: llr[:, None, :].expand(B, L, N)}, {0: ident}
    near_tie = torch.zeros(B, dtype=torch.bool)
    right = [False] * n                 # dir: in the right child at level l

    def read(slot):
        return buf[slot][rows, src[slot]]

    def write(slot, t):
        buf[slot], src[slot] = t, ident

    for op in pscl.node_schedule(spec).tolist():
        code, l, side = op & 15, (op >> 4) & 15, (op >> 8) & 1
        out = n + 1 + 2 * l + side
        if code in (pscl.OP_F, pscl.OP_G):
            a = read(l)
            h = a.shape[-1] // 2
            right[l] = code == pscl.OP_G
            write(l + 1, pscl._f_combine(a[..., :h], a[..., h:])
                  if code == pscl.OP_F else
                  pscl._g_combine(a[..., :h], a[..., h:], read(n + 3 + 2 * l)))
        elif code == pscl.OP_COMB:
            bl, br = read(n + 3 + 2 * l), read(n + 4 + 2 * l)
            write(out, torch.cat((bl ^ br, br), dim=-1))
        elif code == pscl.OP_RATE0:
            metric = metric + pscl._softplus(read(l)).sum(dim=-1)
            write(out, torch.zeros((B, L, N >> l), dtype=torch.bool))
        else:                                   # leaf or repetition fork
            pen0, pen1 = pscl._penalties(read(l))
            cand = torch.stack((metric + pen0.sum(dim=-1),
                                metric + pen1.sum(dim=-1)), dim=-1)
            vals, idx = torch.sort(cand.reshape(B, 2 * L), dim=-1,
                                   stable=True)
            kept, cut = vals[:, L - 1], vals[:, L]
            gap = cut - kept
            near_tie |= (gap > 0) & (gap <= 1e-3 + 1e-4 * kept.abs()) \
                & (cut < pscl.BIG_METRIC)
            metric, parent = vals[:, :L], idx[:, :L] >> 1
            live = [n + 3 + 2 * lv if right[lv] else lv
                    for lv in range(l) if right[lv] or lv]
            for k in live:
                src[k] = src[k].gather(1, parent)
            write(out, (idx[:, :L] & 1).bool()[..., None].expand(
                B, L, N >> l))
    u = ppolar.polar_transform(read(n + 1).to(torch.int32))
    data = u[..., torch.from_numpy(spec.data_pos)]
    crc_ok = ppolar.crc8_check_batch(data[..., :spec.info_len],
                                     data[..., spec.info_len:], spec.crc_mat)
    order = torch.argsort(metric, dim=-1, stable=True)
    return {"info_bits": data[..., :spec.info_len][rows, order].numpy(),
            "crc_ok": crc_ok[rows, order].numpy(),
            "metrics": metric[rows, order].numpy(),
            "near_tie": near_tie.numpy()}


@pytest.mark.parametrize("L", [1, 4, 8])
@pytest.mark.parametrize("which", ["compat", "v2"])
def test_kernel_schedule_replay_matches_walk_and_oracle(which, L):
    """The kernel's node schedule and path-state scheme give the eager
    walk's lists exactly (the same torch arithmetic), on noisy, noiseless
    and zero-LLR rows.  Against the dense oracle (JAX's float32
    arithmetic, its sums in leaf order) the lists are equal path for path
    on every row with no near-tie fork (the zero-LLR row among them, whose
    ties are all exact); a near-tie row must keep the oracle's CRC-passing
    payloads.  Compat's noisy rows all have one: its first info leaves
    carry LLRs of ~1e-7, whose sign is the rounding's."""
    jspec, pspec = _specs(which)
    _, noisy = _coded(jspec, 3, 0.45, 21)
    sent, clean = _coded(jspec, 1, 1e-3, 22)
    llr = np.concatenate([noisy, np.clip(clean, -16.0, 16.0),
                          np.zeros((1, jspec.N), np.float32)])
    got = _replay(torch.from_numpy(llr), pspec, L)
    tied = got.pop("near_tie")
    walk = {k: v.numpy() for k, v in pscl._scl_decode_plain(
        torch.from_numpy(llr), pspec, L).items()}
    oracle = {k: np.asarray(v) for k, v in
              jscl._scl_decode_dense(jnp.asarray(llr), jspec, L).items()}
    for k in ("info_bits", "crc_ok", "metrics"):
        np.testing.assert_array_equal(got[k], walk[k], err_msg=k)
    assert not tied[-1]               # every tie exact: all in index order
    for i in range(len(llr)):
        assert _passing(got, i) == _passing(oracle, i), i
        if tied[i]:
            continue
        np.testing.assert_array_equal(got["info_bits"][i],
                                      oracle["info_bits"][i], err_msg=str(i))
        np.testing.assert_array_equal(got["crc_ok"][i], oracle["crc_ok"][i])
        np.testing.assert_allclose(got["metrics"][i], oracle["metrics"][i],
                                   rtol=1e-4, atol=1e-3)
    assert ppolar.pack_info_bits(got["info_bits"][3, 0]) == sent[0]
    assert got["crc_ok"][3, 0]


@pytest.mark.parametrize("which", ["compat", "v2"])
def test_node_schedule_shape(which):
    """One op per rate-0, leaf or repetition node, f/g/combine around every
    other node; the forks are the info leaves less the repetition nodes'
    frozen ones, and the last op writes the root's partial sums."""
    _, pspec = _specs(which)
    ops = pscl.node_schedule(pspec)
    assert ops.dtype == np.int32 and pscl.node_schedule(pspec) is ops
    code, level = ops & 15, (ops >> 4) & 15
    n = pspec.N.bit_length() - 1
    forks = np.isin(code, (pscl.OP_LEAF, pscl.OP_REP))
    assert forks.sum() == pspec.K
    assert np.all(level[code == pscl.OP_LEAF] == n)
    assert (code == pscl.OP_F).sum() == (code == pscl.OP_G).sum() == \
        (code == pscl.OP_COMB).sum()
    assert code[-1] == pscl.OP_COMB and level[-1] == 0 and ops[-1] >> 8 == 0


def test_cpu_tensors_take_the_walk(monkeypatch):
    """A CPU tensor's exact decode is the eager walk; the kernel is never
    reached, and launches nothing."""
    spec = ppolar.polar_spec()
    _, llr = _coded(spec, 2, 0.45, 5)
    monkeypatch.setattr(pscl, "scl_decode_kernel", None)   # must not be used
    before = build.LAUNCHES["scl_decode"]
    got = pscl.scl_decode(torch.from_numpy(llr), spec, 4)
    want = pscl._scl_decode_plain(torch.from_numpy(llr), spec, 4)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert build.LAUNCHES["scl_decode"] == before


@pytest.mark.parametrize("L", [1024, 1025, 65536])
def test_off_cpu_routing_by_list_size(monkeypatch, L):
    """A tensor off the CPU (a meta tensor stands in for one on the card)
    decodes through the kernel at every list size its 16-bit path maps
    hold, and never through the walk; past them the wrapper refuses, with
    no fallback."""
    spec = ppolar.polar_spec()
    calls = []
    real = pscl.scl_decode_kernel
    monkeypatch.setattr(pscl, "scl_decode_kernel",
                        lambda llr, s, n: calls.append(("kernel", n)))
    monkeypatch.setattr(pscl, "_walk_decode",
                        lambda llr, s, n, **kw: calls.append(("walk", n)))
    x = torch.zeros(2, spec.N, device="meta")
    pscl.scl_decode(x, spec, L)
    assert calls == [("kernel", L)]
    monkeypatch.setattr(pscl, "scl_decode_kernel", real)
    with pytest.raises(ValueError, match="list size"):
        pscl.scl_decode(x, spec, pscl.MAX_LIST + 1)
    assert calls == [("kernel", L)]


def test_kernel_tables_hold_the_crc():
    """The kernel's per-position CRC table: XOR over a codeword's set bits
    gives a word whose two bytes agree exactly when the CRC-8 passes."""
    spec = ppolar.polar_spec()
    info_pos, tab = pscl.kernel_tables(spec, torch.device("cpu"))
    assert info_pos.dtype == tab.dtype == torch.int16
    np.testing.assert_array_equal(info_pos.numpy(),
                                  spec.data_pos[:spec.info_len])
    rng = np.random.default_rng(4)
    u = np.zeros((6, spec.N), np.uint8)
    for i in range(6):
        data = np.unpackbits(np.frombuffer(rng.bytes(spec.info_len // 8),
                                           np.uint8))
        if i < 3:
            data = np.concatenate([data, _crc_bits(data, spec)])
        else:
            data = np.concatenate([data, rng.integers(0, 2, 8)])
        u[i, spec.data_pos] = data
    words = np.bitwise_xor.reduce(
        np.where(u.astype(bool), tab.numpy().view(np.uint16), 0), axis=1)
    want = ppolar.crc8_check_batch(
        torch.from_numpy(u[:, spec.data_pos[:spec.info_len]]).int(),
        torch.from_numpy(u[:, spec.data_pos[spec.info_len:]]).int(),
        torch.from_numpy(spec.crc_mat).float()).numpy()
    np.testing.assert_array_equal((words & 0xff) == (words >> 8), want)
    assert want[:3].all()


def _crc_bits(data, spec):
    return (data.astype(np.int64) @ spec.crc_mat.astype(np.int64)) % 2


def _wide_spec(N):
    """A CRC-8 spec of length ``N`` (any frozen set will do for a refusal)."""
    frozen = np.ones(N, dtype=bool)
    frozen[-64:] = False
    return ppolar.PolarSpec(N=N, K=64, crc_size=8, frozen=frozen,
                            data_pos=np.flatnonzero(~frozen),
                            crc_mat=ppolar.crc8_matrix(56))


@pytest.mark.parametrize("N,shape,L,match", [
    (1024, (2, 1024), 0, "list size"), (1024, (2, 1024), 65537, "list size"),
    (1024, (2, 512), 8, "shape"), (1024, (1024,), 8, "shape"),
    (2048, (2, 2048), 8, "shape"), (1024, (2, 1024), 8, "CUDA")])
def test_kernel_wrapper_refuses(N, shape, L, match):
    """The kernel wrapper raises, before any build or launch, on a list
    size, code length or shape it does not take and on a tensor that is
    not on a CUDA device; an exact decode of a tensor on neither the CPU
    nor a card is routed to it, and so raises too."""
    spec = ppolar.polar_spec() if N == 1024 else _wide_spec(N)
    before = build.LAUNCHES["scl_decode"]
    with pytest.raises(ValueError, match=match):
        pscl.scl_decode_kernel(torch.zeros(shape), spec, L)
    with pytest.raises(ValueError, match="CUDA"):
        pscl.scl_decode(torch.zeros(2, 1024, device="meta"),
                        ppolar.polar_spec(), 8)
    assert build.LAUNCHES["scl_decode"] == before
