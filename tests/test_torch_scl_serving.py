"""echoseal_torch's fast-SSCL serving decoder and ECHOSEAL_SCL_* switches vs
echoseal_tpu's, on the CPU.

The serving walk (min-sum f-combine, hard path metric, rate-1 and SPC nodes
with capped forks) is held against the JAX package's
``_scl_decode_unrolled(serving=True)`` on the same numpy inputs, at the
shapes ``tests/test_scl_proof.py`` compiles (B = 4 noiseless at L = 1 and 8,
the B = 24 waterfall batch at L = 8), so the persistent compile cache can
serve those JAX programs: metrics within rtol = atol = 1e-4, ``info_bits``
and ``crc_ok`` path for path, except that paths whose metrics tie within
that tolerance may come in either order.  The switches route each entry of
the port as they route the JAX package's, but for ``ECHOSEAL_SCL_SERVING=0``,
which the JAX package reads as on and the port as off.
"""
import numpy as np
import pytest
import torch

from echoseal_torch.core import profiles as pprof
from echoseal_torch.models import detector as PD
from echoseal_torch.models import pipeline as PP
from echoseal_torch.models import robust as PR
from echoseal_torch.ops import build
from echoseal_torch.ops import polar as ppolar
from echoseal_torch.ops import scl as pscl
from echoseal_torch.utils import channels
from echoseal_tpu.core import profiles as jprof
from echoseal_tpu.ops import polar as jpolar
from echoseal_tpu.ops import scl as jscl
from torch_port_util import two_torch_threads  # noqa: F401

FS = 48_000
TOL = dict(rtol=1e-4, atol=1e-4)
ENV = ("ECHOSEAL_SCL_IMPL", "ECHOSEAL_SCL_SERVING", "ECHOSEAL_SCL_BLOCK_SEG")


def _specs(which):
    if which == "compat":
        return jpolar.polar_spec(), ppolar.polar_spec()
    return jprof.profile_spec(jprof.ROBUST), pprof.profile_spec(pprof.ROBUST)


def _noiseless(spec):
    rng = np.random.default_rng(7)
    bits = np.stack([jpolar.encode_np(rng.bytes(55), spec) for _ in range(4)])
    return (8.0 * (2.0 * bits - 1.0)).astype(np.float32)


def _awgn(spec, n, sigma, seed, noise_seed):
    rng = np.random.default_rng(seed)
    bits = np.stack([jpolar.encode_np(rng.bytes(55), spec) for _ in range(n)])
    y = (2.0 * bits - 1.0) + sigma * np.random.default_rng(
        noise_seed).standard_normal(bits.shape)
    return (2.0 * y / (sigma * sigma)).astype(np.float32)


def _assert_lists_match(got, want):
    """Metrics within TOL; paths equal one for one, or as multisets inside a
    run of paths whose metrics tie within TOL."""
    np.testing.assert_allclose(got["metrics"], want["metrics"], **TOL)
    np.testing.assert_array_equal(got["crc_ok"].any(-1),
                                  want["crc_ok"].any(-1))
    for i, m in enumerate(want["metrics"]):
        cut = np.flatnonzero(~np.isclose(m[1:], m[:-1], **TOL)) + 1
        for grp in np.split(np.arange(m.size), cut):
            def paths(r):
                return sorted((bool(r["crc_ok"][i, p]),
                               r["info_bits"][i, p].tobytes()) for p in grp)
            if grp.size == 1:
                p = grp[0]
                assert got["crc_ok"][i, p] == want["crc_ok"][i, p], (i, p)
                np.testing.assert_array_equal(got["info_bits"][i, p],
                                              want["info_bits"][i, p])
            else:
                assert paths(got) == paths(want), (i, grp.tolist())


def _both(llr, jspec, pspec, L, block_seg=16):
    want = {k: np.asarray(v) for k, v in jscl._scl_decode_unrolled(
        llr, jspec, L, block_seg, serving=True).items()}
    got = {k: v.numpy() for k, v in pscl._scl_decode(
        torch.from_numpy(llr), pspec, L, serving=True,
        block_seg=block_seg).items()}
    assert got["info_bits"].dtype == np.int32
    assert got["info_bits"].shape == want["info_bits"].shape
    return got, want


def _sort_key(vals, idx):
    """scl_decode.cu's 64-bit fork keys as int64: the float32 values'
    order-preserving bits (-0 as +0, NaN above +inf) over the candidate
    index, so that key order is ``torch.sort(stable=True)``'s order."""
    v = torch.where(vals == 0.0, torch.zeros_like(vals), vals)
    u = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u >= 1 << 31, u ^ 0xFFFFFFFF, u ^ (1 << 31))
    u = torch.where(torch.isnan(vals), torch.full_like(u, 0xFFFFFFFF), u)
    return (u - (1 << 31)) * (1 << 32) + idx


def _top_merge(keep, flip, L):
    """The L smallest of two ascending runs of L unique int64 keys (B, L),
    ascending, as scl_decode.cu's ``warp_top`` takes them: both runs
    padded to Q = 2**ceil(log2 L) with keys above every real one,
    min(A_i, B_(Q-1-i)) (the Q smallest, a bitonic run; no pair holds two
    pads, since L > Q / 2), then bitonic half-cleaners of strides Q/2 ..
    1."""
    B, Q = keep.shape[0], 1 << (L - 1).bit_length()
    pad = torch.iinfo(torch.int64).max - torch.arange(Q - L)
    a = torch.cat((keep, pad.expand(B, Q - L)), dim=1)
    b = torch.cat((flip, pad.flip(0).expand(B, Q - L)), dim=1)
    c = torch.minimum(a, b.flip(1))
    j = Q // 2
    while j:
        x = c.reshape(B, Q // (2 * j), 2, j)
        c = torch.stack((torch.minimum(x[:, :, 0], x[:, :, 1]),
                         torch.maximum(x[:, :, 0], x[:, :, 1])),
                        dim=2).reshape(B, Q)
        j //= 2
    return c[:, :L]


def _serving_replay(llr, spec, L, block_seg):
    """``serving_schedule(spec, block_seg)`` run as scl_decode.cu's serving
    instantiation runs it, in torch ops.

    Slots, source indices and the forks' live columns are
    tests/test_torch_scl.py::_replay's.  A rate-1 or SPC node ranks the
    magnitudes of each of its level's L alpha buffers (stably) and packs
    each buffer's hard decisions; each path carries its ancestor buffer,
    its origin (its index at the node's start) and a flip word over the
    ranks (bit 0 of an SPC node: f0), gathered by the survivors' parents
    at every fork.  A node's first fork sorts all 2L keys; a later one
    sorts the L flip keys and merges them with the keeps, which are
    ascending already (``_top_merge``).  At the node's end the live index
    columns are permuted once, by the origins, and the partial sums are
    the ancestor's hard decisions toggled at the flipped ranks.  The
    decisions are u = x G of the root's sums.
    """
    B, N = llr.shape
    n = N.bit_length() - 1
    rows = torch.arange(B)[:, None]
    ident = torch.arange(L).expand(B, L)
    metric = torch.full((B, L), pscl.BIG_METRIC)
    metric[:, 0] = 0.0
    zero = torch.zeros((B, L))
    buf, src = {0: llr[:, None, :].expand(B, L, N)}, {0: ident}
    right = [False] * n                 # dir: in the right child at level l
    cand_idx = torch.arange(2 * L).expand(B, 2 * L)

    def read(slot):
        return buf[slot][rows, src[slot]]

    def write(slot, t):
        buf[slot], src[slot] = t, ident

    def permute(parent, l):
        for k in [n + 3 + 2 * lv if right[lv] else lv
                  for lv in range(l) if right[lv] or lv]:
            src[k] = src[k].gather(1, parent)

    def fork(pen0, pen1, l):
        nonlocal metric
        cand = torch.stack((metric + pen0, metric + pen1), dim=-1)
        vals, idx = torch.sort(cand.reshape(B, 2 * L), dim=-1, stable=True)
        metric, parent = vals[:, :L], idx[:, :L] >> 1
        permute(parent, l)
        return (idx[:, :L] & 1).bool(), parent

    def node_fork(pen, first):
        """A node's fork by keys; survivors' (bit, parent); no columns."""
        nonlocal metric
        cand = torch.stack((metric, metric + pen), dim=-1).reshape(B, 2 * L)
        keys = _sort_key(cand, cand_idx)
        if first:
            top = torch.sort(keys, dim=-1).values[:, :L]
        else:
            top = _top_merge(keys[:, 0::2],
                             torch.sort(keys[:, 1::2], dim=-1).values, L)
        idx = top & 0xFFFFFFFF
        metric = cand.gather(1, idx)
        return (idx & 1).bool(), idx >> 1

    for op in pscl.serving_schedule(spec, block_seg).tolist():
        code, l, side = op & 15, (op >> 4) & 15, (op >> 8) & 1
        out = n + 1 + 2 * l + side
        if code in (pscl.OP_F, pscl.OP_G):
            a = read(l)
            h = a.shape[-1] // 2
            right[l] = code == pscl.OP_G
            write(l + 1, pscl._f_combine_ms(a[..., :h], a[..., h:])
                  if code == pscl.OP_F else
                  pscl._g_combine(a[..., :h], a[..., h:], read(n + 3 + 2 * l)))
        elif code == pscl.OP_COMB:
            bl, br = read(n + 3 + 2 * l), read(n + 4 + 2 * l)
            write(out, torch.cat((bl ^ br, br), dim=-1))
        elif code == pscl.OP_RATE0:
            metric = metric + torch.relu(read(l)).sum(dim=-1)
            write(out, torch.zeros((B, L, N >> l), dtype=torch.bool))
        elif code in (pscl.OP_LEAF, pscl.OP_REP):
            pen0, pen1 = pscl._penalties_hard(read(l))
            bits, _ = fork(pen0.sum(dim=-1), pen1.sum(dim=-1), l)
            write(out, bits[..., None].expand(B, L, N >> l))
        else:                                   # rate-1 or SPC node
            spc = code == pscl.OP_SPC
            a = buf[l]                          # buffer b of every path
            w = a.shape[-1]
            mag = a.abs()
            order = torch.argsort(mag, dim=-1, stable=True)
            smag = mag.gather(-1, order)
            hard = a > 0.0
            anc, org = src[l], ident
            need = min(L, w) if spc else min(L - 1, w)
            flips = torch.zeros((B, L, w), dtype=torch.bool)   # by rank
            if spc:
                f0 = ((hard.sum(dim=-1) & 1) == 1).gather(1, anc)
                metric = metric + f0.to(torch.float32) * \
                    smag[..., 0].gather(1, anc)
                flips[..., 0] = f0
            for t in range(1 if spc else 0, need):
                pen = smag[..., t].gather(1, anc)
                if spc:
                    f0 = flips[..., 0]
                    pen = pen + (1.0 - 2.0 * f0.to(torch.float32)) * \
                        smag[..., 0].gather(1, anc)
                bits, parent = node_fork(pen, t == (1 if spc else 0))
                anc, org = anc.gather(1, parent), org.gather(1, parent)
                flips = flips[rows, parent]
                flips[..., t] ^= bits
                if spc:
                    flips[..., 0] ^= bits
            if need > (1 if spc else 0):        # the node's one permutation
                permute(org, l)
            toggle = torch.zeros_like(flips).scatter(
                -1, order[rows, anc], flips)
            write(out, hard[rows, anc] ^ toggle)
    u = ppolar.polar_transform(read(n + 1).to(torch.int32))
    data = u[..., torch.from_numpy(spec.data_pos)]
    crc_ok = ppolar.crc8_check_batch(data[..., :spec.info_len],
                                     data[..., spec.info_len:], spec.crc_mat)
    order = torch.argsort(metric, dim=-1, stable=True)
    return {"info_bits": data[..., :spec.info_len][rows, order].numpy(),
            "crc_ok": crc_ok[rows, order].numpy(),
            "metrics": metric[rows, order].numpy()}


def _mixed_rows(jspec, seed):
    """Three noisy rows, a noiseless one and an all-zero one."""
    noisy = _awgn(jspec, 3, 0.45, seed, seed + 1)
    clean = np.clip(_awgn(jspec, 1, 1e-3, seed + 2, seed + 3), -16.0, 16.0)
    return np.concatenate([noisy, clean, np.zeros((1, jspec.N), np.float32)])


# ------------------------------------------------------------ primitives
def test_primitives_equal_jax():
    """Min-sum f, hard penalties and the GF(2) transform, bit for bit, on
    values with zeros and ties."""
    rng = np.random.default_rng(11)
    a = np.concatenate([rng.integers(-3, 4, 512),
                        rng.standard_normal(512) * 6]).astype(np.float32)
    b = np.concatenate([rng.integers(-3, 4, 512),
                        rng.standard_normal(512) * 6]).astype(np.float32)
    assert (a == 0).any() and (np.abs(a) == np.abs(b)).any()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(pscl._f_combine_ms(ta, tb).numpy(),
                                  np.asarray(jscl._f_combine_ms(a, b)))
    np.testing.assert_array_equal(pscl._f_combine_ms(ta, ta).numpy()[a > 0],
                                  -a[a > 0])        # log p1/p0: 1 ^ 1 = 0
    for got, want in zip(pscl._penalties_hard(ta), jscl._penalties_hard(a)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    zero = torch.from_numpy(a == 0)
    assert [float(p[zero].abs().max()) for p in pscl._penalties_hard(ta)
            ] == [0.0, 0.0]
    for seg in (1, 2, 8, 32):
        beta = rng.integers(0, 2, (3, 4, seg)).astype(np.int32)
        want = np.asarray(jscl._gf2_transform(beta))
        np.testing.assert_array_equal(
            pscl._gf2_transform(torch.from_numpy(beta)).numpy(), want)
        np.testing.assert_array_equal(
            pscl._gf2_transform(torch.from_numpy(beta.astype(bool))).numpy(),
            want.astype(bool))


# ------------------------------------------------------- the serving walk
@pytest.mark.parametrize("case", ["noiseless-L1", "noiseless-L8",
                                  "zero-L8", "waterfall-L8"])
@pytest.mark.parametrize("which", ["compat", "v2"])
def test_serving_decode_matches_jax(which, case):
    jspec, pspec = _specs(which)
    kind, L = case.split("-L")
    L = int(L)
    if kind == "noiseless":
        llr = _noiseless(jspec)
    elif kind == "zero":                       # every candidate ties
        llr = np.zeros((4, jspec.N), np.float32)
    else:                                      # test_scl_proof's batch
        llr = _awgn(jspec, 24, 0.35, 4242, 31)
    got, want = _both(llr, jspec, pspec, L)
    _assert_lists_match(got, want)
    if kind == "zero":
        for k in ("info_bits", "crc_ok", "metrics"):
            np.testing.assert_array_equal(got[k], want[k])
    elif kind == "noiseless":
        assert got["crc_ok"][:, 0].all() and (got["metrics"][:, 0] == 0).all()
    else:
        assert got["crc_ok"].any()


def test_block_seg_8_matches_jax(monkeypatch):
    """``ECHOSEAL_SCL_BLOCK_SEG=8``: 16-leaf nodes, as the JAX package's."""
    jspec, pspec = _specs("v2")
    llr = _awgn(jspec, 4, 0.45, 99, 100)
    monkeypatch.setenv("ECHOSEAL_SCL_IMPL", "serving")
    monkeypatch.setenv("ECHOSEAL_SCL_BLOCK_SEG", "8")
    got = {k: v.numpy() for k, v in pscl.scl_decode(
        torch.from_numpy(llr), pspec, 8).items()}
    want = {k: np.asarray(v) for k, v in jscl._scl_decode_unrolled(
        llr, jspec, 8, 8, serving=True).items()}
    _assert_lists_match(got, want)
    assert pscl._node_level(10, 8) == 6 and pscl._node_level(10, 16) == 5


# ------------------------------------------------- the kernel's schedule
@pytest.mark.parametrize("which,block_seg,ops,forks", [
    ("compat", 16, 885, {1: 46, 8: 279, 32: 443, 256: 448}),
    ("compat", 8, 905, {1: 46, 8: 314, 32: 448, 256: 448}),
    ("v2", 16, 341, {1: 25, 8: 247, 32: 444, 256: 448}),
    ("v2", 8, 365, {1: 25, 8: 289, 32: 448, 256: 448})])
def test_serving_schedule_shape(which, block_seg, ops, forks):
    """The serving walk's node order: fewer ops and, at small L, fewer forks
    than the exact schedule (2257 compat, 1857 v2 ops, 448 forks); rate-1
    and SPC nodes only from ``_node_level`` on, with the JAX block's span."""
    _, pspec = _specs(which)
    words = pscl.serving_schedule(pspec, block_seg)
    assert words.dtype == np.int32 and words.size == ops
    assert pscl.serving_schedule(pspec, block_seg) is words
    N, n = pspec.N, pspec.N.bit_length() - 1
    assert {L: pscl.schedule_forks(words, N, L) for L in forks} == forks
    exact = pscl.node_schedule(pspec)
    assert {pscl.schedule_forks(exact, N, L) for L in forks} == {pspec.K}
    code, level = words & 15, (words >> 4) & 15
    node = np.isin(code, (pscl.OP_RATE1, pscl.OP_SPC))
    assert node.any() and (level[node] >= pscl._node_level(n, block_seg)).all()
    assert pscl._node_span(words, N) == 2 * block_seg
    assert code[-1] == pscl.OP_COMB and level[-1] == 0
    wide = pscl.serving_schedule(pspec, 4096)       # spans up to N / 2
    assert pscl._node_level(n, 4096) == 1
    assert pscl._node_span(wide, N) <= N // 2
    pscl._check_ops(torch.from_numpy(wide), torch.device("cpu"), n, True)


@pytest.mark.parametrize("which,L,block_seg", [
    ("compat", 1, 16), ("compat", 4, 16), ("compat", 8, 16), ("v2", 1, 16),
    ("v2", 4, 16), ("v2", 8, 16), ("compat", 8, 8), ("v2", 8, 64)])
def test_serving_replay_equals_walk(which, L, block_seg):
    """The kernel's serving schedule and node-state scheme give the eager
    serving walk's lists bit for bit (the same torch arithmetic), on noisy,
    noiseless and zero-LLR rows, at the default node size, at 16-leaf nodes
    and at 64-leaf ones (the kernel's ranks counted through memory)."""
    jspec, pspec = _specs(which)
    llr = _mixed_rows(jspec, 40 + L)
    got = _serving_replay(torch.from_numpy(llr), pspec, L, block_seg)
    walk = {k: v.numpy() for k, v in pscl._walk_decode(
        torch.from_numpy(llr), pspec, L, serving=True,
        block_seg=block_seg).items()}
    for k in ("info_bits", "crc_ok", "metrics"):
        np.testing.assert_array_equal(got[k], walk[k], err_msg=k)
    assert got["crc_ok"][3, 0] and got["metrics"][3, 0] == 0.0


@pytest.mark.parametrize("case", ["noiseless-L1", "noiseless-L8",
                                  "zero-L8", "waterfall-L8"])
@pytest.mark.parametrize("which", ["compat", "v2"])
def test_serving_replay_matches_jax(which, case):
    """The replay against the JAX package's one-program serving decode at
    the shapes of ``test_serving_decode_matches_jax`` (compiled once)."""
    jspec, pspec = _specs(which)
    kind, L = case.split("-L")
    L = int(L)
    llr = {"noiseless": lambda: _noiseless(jspec),
           "zero": lambda: np.zeros((4, jspec.N), np.float32),
           "waterfall": lambda: _awgn(jspec, 24, 0.35, 4242, 31)}[kind]()
    want = {k: np.asarray(v) for k, v in jscl._scl_decode_unrolled(
        llr, jspec, L, 16, serving=True).items()}
    got = _serving_replay(torch.from_numpy(llr), pspec, L, 16)
    _assert_lists_match(got, want)


@pytest.mark.parametrize("L", [1, 2, 3, 5, 8, 13, 16, 17, 31, 32, 33, 64])
def test_top_merge_equals_full_sort(L):
    """A node fork after the first: the keeps of the previous fork's
    survivors (in rank order, so ascending) and the sorted flips, merged by
    ``_top_merge``, give the same survivors in the same order as a stable
    sort of all 2L candidates, on rows with tied metrics, BIG_METRIC dead
    paths, NaN, -0 beside +0 and zero penalties; and the 64-bit keys sort
    as ``torch.sort(stable=True)`` does (a node's first fork)."""
    rng = np.random.default_rng(L)
    B = 48
    pool = np.array([0.0, -0.0, 0.5, 1.0, 1.0, 2.5, pscl.BIG_METRIC, np.nan],
                    np.float32)
    m = np.where(rng.random((B, L)) < 0.5, rng.choice(pool, (B, L)),
                 rng.exponential(2.0, (B, L))).astype(np.float32)
    m[0] = pscl.BIG_METRIC                            # every path dead
    m[1] = 0.0                                        # every path tied
    pen = np.where(rng.random((B, L)) < 0.4,
                   rng.choice(np.array([0.0, 0.5, np.nan], np.float32),
                              (B, L)),
                   rng.exponential(1.0, (B, L))).astype(np.float32)
    pen[1] = 0.0
    keep = torch.sort(torch.from_numpy(m), dim=-1, stable=True).values
    cand = torch.stack((keep, keep + torch.from_numpy(pen)),
                       dim=-1).reshape(B, 2 * L)
    want = torch.sort(cand, dim=-1, stable=True).indices[:, :L]
    keys = _sort_key(cand, torch.arange(2 * L).expand(B, 2 * L))
    assert (keys[:, 0::2].diff(dim=-1) > 0).all()     # the keeps ascend
    got = _top_merge(keys[:, 0::2], torch.sort(keys[:, 1::2], dim=-1).values,
                     L)
    assert torch.equal(got & 0xFFFFFFFF, want)
    assert torch.equal(torch.sort(keys, dim=-1).values[:, :L] & 0xFFFFFFFF,
                       want)


# ---------------------------------------------------------- the kernel
def test_cpu_tensors_take_the_serving_walk(monkeypatch):
    """A CPU tensor's serving decode is the eager walk: the kernel wrapper
    is never reached and launches nothing."""
    _, pspec = _specs("v2")
    llr = torch.from_numpy(_awgn(pspec, 2, 0.45, 5, 6))
    monkeypatch.setattr(pscl, "scl_decode_serving_kernel", None)
    before = dict(build.LAUNCHES)
    got = pscl._scl_decode(llr, pspec, 4, serving=True, block_seg=8)
    want = pscl._walk_decode(llr, pspec, 4, serving=True, block_seg=8)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert dict(build.LAUNCHES) == before


@pytest.mark.parametrize("entry,env,want", [
    ("scl_decode", {"IMPL": "serving"}, ("serving", 8, 16)),
    ("scl_decode", {"IMPL": "serving", "BLOCK_SEG": "64"}, ("serving", 8, 64)),
    ("scl_decode_serving", {"SERVING": "1", "BLOCK_SEG": "8"},
     ("serving", 8, 8)),
    ("scl_decode_serving", {"SERVING": "0"}, ("exact", 8)),
    ("scl_decode", {}, ("exact", 8))])
def test_off_cpu_serving_routing(monkeypatch, entry, env, want):
    """A tensor off the CPU (a meta tensor stands in for one on the card):
    every serving decode goes to the serving kernel's wrapper at the
    switches' ``block_seg``, every exact one to the exact kernel's, and
    none to the walk."""
    _, pspec = _specs("compat")
    calls = []
    monkeypatch.setattr(pscl, "scl_decode_serving_kernel",
                        lambda x, s, L, bs: calls.append(("serving", L, bs)))
    monkeypatch.setattr(pscl, "scl_decode_kernel",
                        lambda x, s, L: calls.append(("exact", L)))
    monkeypatch.setattr(pscl, "_walk_decode",
                        lambda *a, **k: calls.append("walk"))
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(f"ECHOSEAL_SCL_{k}", v)
    getattr(pscl, entry)(torch.zeros(2, pspec.N, device="meta"), pspec, 8)
    assert calls == [want]


@pytest.mark.parametrize("shape,L,block_seg,match", [
    ((2, 1024), 0, 16, "list size"), ((2, 1024), 65537, 16, "list size"),
    ((2, 512), 8, 16, "shape"), ((1024,), 8, 16, "shape"),
    ((2, 1024), 8, 0, "block_seg"), ((2, 1024), 8, "16", "block_seg"),
    ((2, 1024), 8, True, "block_seg"), ((2, 1024), 8, 16, "CUDA")])
def test_serving_kernel_wrapper_refuses(shape, L, block_seg, match):
    """The serving wrapper raises, before any build or launch, on a list
    size, shape or ``block_seg`` it does not take and on a tensor that is
    not on a CUDA device; through ``_scl_decode`` a meta tensor reaches it
    and raises too."""
    _, pspec = _specs("compat")
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        pscl.scl_decode_serving_kernel(torch.zeros(shape), pspec, L,
                                       block_seg)
    with pytest.raises(ValueError, match="CUDA"):
        pscl._scl_decode(torch.zeros(2, 1024, device="meta"), pspec, 8,
                         serving=True, block_seg=16)
    assert dict(build.LAUNCHES) == before


def test_serving_op_words_checked():
    """The serving decoder takes the rate-1 and SPC node ops from level 1
    to n - 1; the exact decoder takes none."""
    cpu = torch.device("cpu")
    _, pspec = _specs("v2")
    words = torch.from_numpy(pscl.serving_schedule(pspec, 16))
    assert pscl._check_ops(words, cpu, 10, serving=True) == 32
    with pytest.raises(ValueError, match="out of range"):
        pscl._check_ops(words, cpu, 10)
    for word in (pscl._op(pscl.OP_RATE1, 0, 0), pscl._op(pscl.OP_SPC, 10, 1),
                 pscl._op(pscl.OP_SPC + 1, 3, 0), 1 << 9):
        with pytest.raises(ValueError, match="out of range"):
            pscl._check_ops(torch.tensor([word], dtype=torch.int32), cpu, 10,
                            serving=True)


# ------------------------------------------------------------- switches
def _route_port(monkeypatch):
    def fake(llr, spec, L, serving=False, block_seg=pscl.BLOCK_SEG):
        return ("serving", block_seg) if serving else "exact"
    monkeypatch.setattr(pscl, "_scl_decode", fake)


def _route_jax(monkeypatch):
    def unrolled(llr, spec, L, block_seg=16, serving=False):
        return ("serving", block_seg) if serving else "exact"
    monkeypatch.setattr(jscl, "_scl_decode_unrolled", unrolled)
    for name in ("_scl_decode_lazy", "_scl_decode_blocked",
                 "_scl_decode_dense"):
        monkeypatch.setattr(jscl, name, lambda *a, **k: "exact")


@pytest.mark.parametrize("entry,env,port,jax", [
    ("scl_decode", {}, "exact", "exact"),
    ("scl_decode", {"IMPL": "serving"}, ("serving", 16), ("serving", 16)),
    ("scl_decode", {"IMPL": "serving", "BLOCK_SEG": "8"}, ("serving", 8),
     ("serving", 8)),
    ("scl_decode", {"IMPL": "unrolled"}, "exact", "exact"),
    ("scl_decode", {"IMPL": "blocked"}, "exact", "exact"),
    ("scl_decode", {"IMPL": "lazy"}, "exact", "exact"),
    ("scl_decode", {"IMPL": "dense"}, "exact", "exact"),
    ("scl_decode", {"IMPL": "servng"}, ValueError, ValueError),
    ("scl_decode", {"SERVING": "1"}, "exact", "exact"),
    ("scl_decode_serving", {}, "exact", "exact"),
    ("scl_decode_serving", {"SERVING": "1"}, ("serving", 16), ("serving", 16)),
    ("scl_decode_serving", {"SERVING": "1", "BLOCK_SEG": "8"}, ("serving", 8),
     ("serving", 8)),
    ("scl_decode_serving", {"SERVING": "1", "IMPL": "lazy"}, "exact", "exact"),
    ("scl_decode_serving", {"IMPL": "serving"}, ("serving", 16),
     ("serving", 16)),
    ("scl_decode_serving", {"SERVING": "1", "IMPL": "typo"}, ValueError,
     ValueError),
    ("scl_decode_serving", {"SERVING": ""}, "exact", "exact"),
    # the one divergence: the JAX package reads any non-empty value as on
    ("scl_decode_serving", {"SERVING": "0"}, "exact", ("serving", 16)),
])
def test_switch_routing(monkeypatch, entry, env, port, jax):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(f"ECHOSEAL_SCL_{k}", v)
    _route_port(monkeypatch)
    _route_jax(monkeypatch)
    for mod, want in ((pscl, port), (jscl, jax)):
        fn = getattr(mod, entry)
        if want is ValueError:
            with pytest.raises(ValueError, match="'serving', 'unrolled', "
                               "'blocked', 'lazy', 'dense'"):
                fn(None, None, 8)
        else:
            assert fn(None, None, 8) == want, mod.__name__


# ------------------------------------------------------------ call sites
def _spy_decoder(monkeypatch):
    """Record (serving, L, rows) of every decode the port runs."""
    calls = []
    orig = pscl._scl_decode

    def spy(llr, spec, L, **kw):
        calls.append((kw.get("serving", False), int(L), int(llr.shape[0])))
        return orig(llr, spec, L, **kw)
    monkeypatch.setattr(pscl, "_scl_decode", spy)
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    return calls


def _v2_corpus(key32):
    """tests/test_torch_robust.py's ``v2_batch`` corpus at seed 0."""
    T, TPAD = int(3.5 * FS), 1 << 18
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(T) / FS)
            ).astype(np.float32)
    tx_loud = PR.RobustEmbedder(key32, rng=np.random.default_rng(0))
    tx_loud._session_nonce = b"sessionA"
    wm_loud = tx_loud.process(host)
    tx_sil = PR.RobustEmbedder(key32, rng=np.random.default_rng(1))
    tx_sil._session_nonce = b"sessionB"
    wm_sil = tx_sil.process(np.zeros(T, np.float32))
    rms = float(np.sqrt(np.mean(wm_sil**2)))
    rng = np.random.default_rng(3)
    clips = np.zeros((4, TPAD), np.float32)
    clips[0, :T] = wm_loud
    clips[1, :T] = channels.codec_sim(wm_loud, 128.0)[:T]
    clips[2, :T] = wm_sil + rms * 10 ** (-4 / 20) * rng.standard_normal(
        T).astype(np.float32)
    clips[3, :T] = 0.05 * rng.standard_normal(T).astype(np.float32)
    return clips, np.full(4, T, dtype=np.int32)


@pytest.fixture(scope="module")
def corpus(key32):
    return _v2_corpus(key32)


def test_ladder_serving_switch(key32, corpus, monkeypatch):
    """``ECHOSEAL_SCL_SERVING=1``: every rung of the batch ladder decodes
    through the serving walk at its L, with the exact ladder's verdicts."""
    clips, nv = corpus
    calls = _spy_decoder(monkeypatch)
    pv = PP.RobustBatchVerifier(key32, max_ctr=4096, device="cpu")
    exact_details = {}
    v_exact = pv.verify_batch(clips, nv, details=exact_details)
    assert calls and not any(s for s, _, _ in calls)
    calls.clear()
    monkeypatch.setenv("ECHOSEAL_SCL_SERVING", "1")
    details = {}
    v = pv.verify_batch(clips, nv, details=details)
    assert v.tolist() == v_exact.tolist() == [True, True, True, False]
    assert details[2].stage == exact_details[2].stage == "scl"
    assert details[2].session_nonce == b"sessionB"
    assert [(True, L, n) for _, L, n, _ in pv.scl_rungs] == calls


def test_single_clip_tiers_follow_impl_only(key32, corpus, monkeypatch):
    """``ECHOSEAL_SCL_IMPL=serving`` reaches both single-clip tiers'
    decodes; ``ECHOSEAL_SCL_SERVING`` does not (as in the JAX package)."""
    clips, nv = corpus
    calls = _spy_decoder(monkeypatch)
    det = PD.WatermarkDetector(key32, list_size=8, device="cpu")
    rv = PR.RobustVerifier(key32, list_size=8, device="cpu")
    noise = (0.1 * np.random.default_rng(5).standard_normal(nv[0])
             ).astype(np.float32)
    for env, serving in (("ECHOSEAL_SCL_SERVING", False),
                         ("ECHOSEAL_SCL_IMPL", True)):
        monkeypatch.setenv(env, "1" if env.endswith("SERVING") else "serving")
        assert not det.verify_detailed(noise, FS).authentic
        assert calls and {c[:2] for c in calls} == {(serving, 8)}
        calls.clear()
        rv.session_nonce = None
        r = rv.verify_detailed(clips[2, :nv[2]], FS)
        assert r.authentic and r.stage == "scl"
        assert calls and {c[:2] for c in calls} == {(serving, 8)}
        calls.clear()
        monkeypatch.delenv(env)
