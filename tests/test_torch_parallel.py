"""echoseal_torch data parallelism (``parallel/``) vs echoseal_tpu's, CPU.

The JAX package splits over the conftest's 8-device CPU mesh
(``shard_map``); the port runs in a world-size-1 ``gloo`` group (a module
fixture on a ``FileStore``), so split, collectives and gather all run, and
its sharded outputs must equal its unsharded ones exactly.  The same seeded
inputs go to both packages, on identical tables:

* ``shard_verify`` on 8 compat clips of tests/test_pipeline.py's geometry,
  under the contract of ROADMAP C1: peaks, header reads and counters
  exact, preamble score within 1e-4, the decode of identical chips exact,
  ``finish_host`` verdicts row-identical, the all-reduced ``n_crc_ok`` >= 8
  and equal to the unsharded count;
* ``shard_verify_v2`` on 8 rows at the dry run's geometry (``T2 = 1 <<
  15``, ``max_ctr`` 64), one without a watermark, under C3: peak scores
  within 1e-4 rank by rank, chips within 1e-4 of each row's largest,
  ``_finish_ladder`` verdicts row-identical;
* ``shard_tx``: frames within 2e-5 (``chip_smoke.py`` phase 12);
* ``shard_scan_v2`` and ``shard_resample_v2`` on 8 rows played 3.1 % fast:
  scores within 1e-4 relative, resampled rows within 1e-5 of each row's
  largest at the same ``n_out``.

World size 2 runs as ``python -m echoseal_torch.parallel.dryrun 2 --device
cpu``, which also holds each rank's gathered outputs equal to an unsharded
run; ``MULTICHIP_r05.json`` is the JAX record of the same marker.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from echoseal_torch.convert import (
    TABLE_DTYPES,
    V2_TABLE_DTYPES,
    numpy_tables_of,
)
from echoseal_torch.core.bandplan import hop_schedule
from echoseal_torch.core.crypto import SecureChannel
from echoseal_torch.core.params import FRAME_LEN, HDR_L, PRE_L
from echoseal_torch.core.profiles import ROBUST
from echoseal_torch.core.sequences import (
    bits_to_bpsk,
    header_bits_batch,
    mls63,
)
from echoseal_torch.models import pipeline as PP
from echoseal_torch.models.embedder import _seal_frames, frames_np
from echoseal_torch.models.robust import RobustEmbedder
from echoseal_torch.ops import demod
from echoseal_torch.parallel import mesh as pmesh
from echoseal_torch.utils import channels
from echoseal_tpu.models import pipeline as JPL
from echoseal_tpu.models import robust as jrobust
from echoseal_tpu.ops import filters as jfilters
from echoseal_tpu.parallel import mesh as jmesh
from torch_port_util import two_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
FS = 48_000
T, TPAD = 3 * FS, 1 << 18
T2 = 1 << 15
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A world-size-1 gloo group for this module, and the port's mesh."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("dist") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield pmesh.streams_mesh(device="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.streams_mesh()


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _assert_same(got: dict, want: dict):
    """Sharded (world size 1) == unsharded, key by key, bit for bit."""
    assert set(got) == set(want) | {"n_crc_ok"}
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(
            got[k].nan_to_num(), w.nan_to_num()), k
    assert int(got["n_crc_ok"]) == int(want["crc_ok"].sum())
    assert got["n_crc_ok"].dtype == torch.int32 and got["n_crc_ok"].ndim == 0


# ------------------------------------------------------------- the mesh
def test_streams_mesh_and_split_rules(mesh, monkeypatch):
    assert pmesh.STREAM_AXIS == jmesh.STREAM_AXIS == "streams"
    assert mesh == (None, 0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="gloo"):
        pmesh.streams_mesh(device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.streams_mesh()
    two = pmesh.StreamsMesh(None, 1, 2, torch.device("cpu"))
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(pmesh._rows(two, x).numpy(), x[3:])
    with pytest.raises(ValueError, match="does not split"):
        pmesh._rows(two, x[:5])
    pv = PP.BatchVerifier.__new__(PP.BatchVerifier)
    pv.device = torch.device("cpu")
    pmesh._check_device(pv, mesh)
    with pytest.raises(TypeError):
        pmesh.shard_verify_v2(pv, mesh)
    # device=None is this process's card, not rank % the card count: rank 4
    # of 8 on a 2-card node bound to its second card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 8)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert pmesh.streams_mesh() == (None, 4, 8, torch.device("cuda", 1))
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert pmesh.streams_mesh().device == torch.device("cuda", 0)


# -------------------------------------------------------- compat verify
@pytest.fixture(scope="module")
def compat(key32):
    """8 watermarked 3 s clips at mid-stream counters, both verifiers."""
    jv = JPL.BatchVerifier(key32, max_ctr=4096)
    pv = PP.BatchVerifier.from_tables(key32, numpy_tables_of(jv, TABLE_DTYPES),
                                      device="cpu")
    rng = np.random.default_rng(1)
    n_frames = -(-T // FRAME_LEN)
    clips = np.zeros((8, TPAD), dtype=np.float32)
    for i in range(8):
        sc = int(rng.integers(0, 2000))
        fr = frames_np(pv.sec, pv._hop, np.arange(sc, sc + n_frames),
                       bytes(8), rng=rng)
        clips[i, :T] = fr.reshape(-1)[:T] * 10.0 ** (-35.0 / 20.0)
    return clips, np.full(8, T, dtype=np.int32), jv, pv


def test_shard_verify_matches_jax(compat, mesh, jax_mesh):
    clips, nv, jv, pv = compat
    jo = _np(jmesh.shard_verify(jv, jax_mesh)(clips, nv))
    po = pmesh.shard_verify(pv, mesh)(clips, nv)
    _assert_same(po, pv.run_device(clips, nv))
    pn = {k: v.numpy() for k, v in po.items()}
    for k in ("peak_idx", "hdr_ok", "hdr_lo16", "ctr"):
        np.testing.assert_array_equal(pn[k], jo[k], err_msg=k)
    for k in ("peak_val", "pre_score"):
        np.testing.assert_allclose(pn[k], jo[k], **TOL, err_msg=k)
    # the decode of the JAX package's chips is exact
    redo = PP._decode_stage(*(torch.tensor(jo[k]) for k in
                              ("chips", "peak_idx", "peak_val")), pv.tables)
    for k in ("crc_ok", "info_bits", "host_packed", "ok", "blob_ctr"):
        np.testing.assert_array_equal(redo[k].numpy(), jo[k], err_msg=k)
    assert int(po["n_crc_ok"]) >= 8 and int(jo["n_crc_ok"]) >= 8
    v_p = pv.finish_host(po, expected_nonce=bytes(8))
    v_j = jv.finish_host(jo, expected_nonce=bytes(8))
    assert v_p.tolist() == v_j.tolist() == [True] * 8
    assert not pv.finish_host(po, expected_nonce=b"someone!").any()


# ------------------------------------------------------------ v2 verify
@pytest.fixture(scope="module")
def v2(key32):
    """8 v2 rows at the dry run's geometry (the last one noise), both
    verifiers on identical tables."""
    jv = JPL.RobustBatchVerifier(key32, max_ctr=64)
    pv = PP.RobustBatchVerifier.from_tables(
        key32, numpy_tables_of(jv, V2_TABLE_DTYPES), device="cpu")
    tx = RobustEmbedder(key32, rng=np.random.default_rng(2))
    span = tx.profile.span
    stream = tx.embed(np.zeros(11 * span, np.float32),
                      session_nonce=b"dryrun!!")
    clips = np.stack([stream[d * span: d * span + T2] for d in range(8)])
    clips[7] = 0.05 * np.random.default_rng(3).standard_normal(T2)
    return clips, np.full(8, T2, dtype=np.int32), jv, pv


def test_shard_verify_v2_matches_jax(v2, mesh, jax_mesh):
    clips, nv, jv, pv = v2
    jo = _np(jmesh.shard_verify_v2(jv, jax_mesh)(clips, nv))
    po = pmesh.shard_verify_v2(pv, mesh)(clips, nv)
    _assert_same(po, pv.run_device(clips, nv))
    pn = {k: v.numpy() for k, v in po.items()}
    assert pn["host_packed"].shape == jo["host_packed"].shape == (8, 65)
    # peak scores rank by rank, then the chips of each matched peak
    np.testing.assert_allclose(-np.sort(-pn["peak_val"], -1),
                               -np.sort(-jo["peak_val"], -1), **TOL)
    real = pn["peak_idx"][:7]
    np.testing.assert_array_equal(real, jo["peak_idx"][:7])
    row_err = np.abs(pn["chips"][:7] - jo["chips"][:7]).max(-1)
    assert np.all(row_err <= 1e-4 * np.abs(jo["chips"][:7]).max(-1))
    assert int(po["n_crc_ok"]) >= 7
    v_p = pv._finish_ladder(po, b"dryrun!!", True, 1 << 20)
    v_j = jv._finish_ladder(jo, b"dryrun!!", True, 1 << 20)
    assert v_p.tolist() == v_j.tolist() == [True] * 7 + [False]
    assert not pv._finish_ladder(po, b"someone!", False, 1 << 20).any()


# ------------------------------------------------------------------- TX
def test_shard_tx_matches_jax(key32, mesh, jax_mesh):
    sec, hop = SecureChannel(key32), hop_schedule(key32)
    ctrs = np.arange(100, 116, dtype=np.int64)
    blobs = _seal_frames(sec, ctrs, b"dryrun!!", np.random.default_rng(4))
    info = np.unpackbits(np.frombuffer(b"".join(blobs), np.uint8).reshape(
        ctrs.size, -1), axis=-1)
    hdr = header_bits_batch(ctrs)
    pn = sec.pn_bits_batch(ctrs, FRAME_LEN)[:, PRE_L + HDR_L:]
    hdr_pn_sy = bits_to_bpsk(sec.pn_bits(0, HDR_L)).astype(np.float32)
    pre_sy = bits_to_bpsk(mls63()).astype(np.float32)
    bands = hop.indices(ctrs)
    want = np.asarray(jmesh.shard_tx(jax_mesh)(
        jnp.asarray(info), jnp.asarray(hdr), jnp.asarray(pn),
        jnp.asarray(hdr_pn_sy), jnp.asarray(pre_sy),
        jnp.asarray(jfilters.all_band_sos(FS)[bands])))
    got = pmesh.shard_tx(mesh)(info, hdr, pn, hdr_pn_sy, pre_sy, bands,
                               demod.all_forward_matrices(FS))
    assert got.shape == (16, FRAME_LEN) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


# ------------------------------------------------------ scan + resample
def test_shard_scan_and_resample_match_jax(v2, mesh, jax_mesh):
    clips, _, jv, pv = v2
    rows = np.zeros_like(clips)
    nv = np.zeros(8, np.int32)
    for i, c in enumerate(clips):
        y = channels.time_scale(c, 1.031)
        rows[i, :min(y.size, T2)] = y[:T2]
        nv[i] = min(y.size, T2)
    want = np.asarray(jmesh.shard_scan_v2(jv, jax_mesh)(rows, nv))
    # the scan bank too is the JAX package's design, as the other tables
    # (test_torch_recover.py holds the two designs equal)
    pv._scan_bank = torch.from_numpy(jrobust.scaled_template_bank(
        FS, ROBUST.oversample))
    got = pmesh.shard_scan_v2(pv, mesh)(rows, nv)
    assert got.shape == want.shape == (8, 124)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=0)

    den = 11640                                  # the scan's pick for 1.031
    yj, nj = jmesh.shard_resample_v2(jv, jax_mesh, T2)(jnp.asarray(rows), den)
    yp, np_ = pmesh.shard_resample_v2(pv, mesh, T2)(rows, den)
    yj = np.asarray(yj)
    assert np_ == nj == -(-T2 * 12_000 // den)
    L = min(np_, yp.shape[1], yj.shape[1])
    err = np.abs(yp.numpy()[:, :L] - yj[:, :L]).max(-1)
    assert np.all(err <= 1e-5 * np.abs(yj[:, :L]).max(-1))


# -------------------------------------------------------- world size 2
def test_dryrun_two_gloo_ranks():
    """Split and gather at world size 2 in two processes: every verdict 1,
    every clip recovered, gathered outputs equal the unsharded run's."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "echoseal_torch.parallel.dryrun", "2",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    m = re.search(r"^DRYRUN_OK n_devices=2 verdicts=\[1, 1\] n_crc_ok=(\d+) "
                  r"v2_verdicts=\[1, 1\] v2_n_crc_ok=(\d+) recovered=2$",
                  proc.stdout, re.M)
    assert m, proc.stdout
    assert int(m.group(1)) >= 2 and int(m.group(2)) >= 2


def test_dryrun_needs_a_card_without_device_cpu(monkeypatch):
    from echoseal_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        dryrun.main(["1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="2 ranks need 2 CUDA cards"):
        dryrun.main(["2"])
