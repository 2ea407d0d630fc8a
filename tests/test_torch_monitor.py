"""echoseal_torch monitors, verifier pool and sessions vs echoseal_tpu's,
on the CPU.

The cases of tests/test_monitor.py, tests/test_service.py and
tests/test_session.py, each on the same seeded stream through both
packages (WAV I/O and the CLIs: tests/test_torch_cli.py):

* ``StreamMonitor`` (compat and v2): every event's window times and
  ``VerifyResult`` fields equal, the session latch carried across windows.
* ``BatchStreamMonitor``: window times, verdicts and the accept details
  (stage, counter, session nonce) equal, and each accepted counter lies
  inside its window.  (The port's batch tier opens every CRC-passing
  candidate where the JAX package opens the first, ROADMAP C2, so on
  another stream the two could name different frames of one window; on
  these seeded streams they name the same.)
* ``VerifierPool``: per-key isolation, LRU eviction, verdicts right after a
  rebuild, equal to the JAX pool's.
* Checkpoints written by one package load in the other.
"""
import logging

import numpy as np
import pytest
import torch

from echoseal_torch.convert import (
    DETECTOR_TABLE_DTYPES,
    V2_TABLE_DTYPES,
    VERIFIER_TABLE_DTYPES,
    numpy_tables_of,
)
from echoseal_torch.core import session
from echoseal_torch.core.bandplan import hop_schedule
from echoseal_torch.core.params import FRAME_LEN
from echoseal_torch.models import monitor as PM
from echoseal_torch.models import pipeline as PP
from echoseal_torch.models.detector import WatermarkDetector
from echoseal_torch.models.embedder import BatchEmbedder, WatermarkEmbedder
from echoseal_torch.models.robust import RobustEmbedder, RobustVerifier
from echoseal_torch.models.service import VerifierPool
from echoseal_tpu.core import session as j_session
from echoseal_tpu.models import monitor as JM
from echoseal_tpu.models import pipeline as JPL
from echoseal_tpu.models.detector import WatermarkDetector as JDetector
from echoseal_tpu.models.embedder import WatermarkEmbedder as JEmbedder
from echoseal_tpu.models.service import VerifierPool as JPool
from torch_port_util import (  # noqa: F401
    compat_stream,
    two_torch_threads,
    v2_stream,
)

FS = 48_000
KEY_A = bytes.fromhex("aa" * 32)
KEY_B = bytes.fromhex("bb" * 32)
HEX_A, HEX_B = "aa" * 32, "bb" * 32
FIELDS = ("authentic", "frame_ctr", "band", "peak_pos", "stage",
          "session_nonce")


def assert_events_equal(got, want, fields=FIELDS, hop=None):
    """Window times and result fields equal, event by event.

    With ``hop`` (compat single-clip results): when the two packages
    accepted on different tries, a marginal candidate's decode tipped
    (ROADMAP C1) and they may name different frames of the window; then
    each counter must be the one its own peak position implies.
    """
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.t_start, g.t_end) == (w.t_start, w.t_end)
        if hop is not None and g.result.tries != w.result.tries:
            for f in ("authentic", "stage", "session_nonce"):
                assert getattr(g.result, f) == getattr(w.result, f), (f, g, w)
            for r in (g.result, w.result):
                at = round(g.t_start * FS) + r.peak_pos
                assert abs(r.frame_ctr * FRAME_LEN - at) <= 2, (g, w)
                assert r.band == hop.band(r.frame_ctr), (g, w)
            continue
        for f in fields:
            assert getattr(g.result, f) == getattr(w.result, f), (f, g, w)


def run_monitors(mons, feeds):
    """Feed the same blocks to both monitors; events of (port, JAX)."""
    out = []
    for mon in mons:
        events = []
        for block in feeds:
            events += mon.feed(block)
        out.append(events + mon.flush())
    return out


# ------------------------------------------------------------ StreamMonitor
@pytest.fixture(scope="module")
def dets(key32):
    """One detector per package on identical tables, shared by the monitors
    below (each test starts them from an open latch)."""
    jd = JDetector(key32, list_size=8)
    pd = WatermarkDetector.from_tables(
        key32, numpy_tables_of(jd, DETECTOR_TABLE_DTYPES), device="cpu",
        list_size=8)
    return pd, jd


def compat_monitors(dets, **kw):
    for d in dets:
        d.session_nonce = None
    return (PM.StreamMonitor(b"", verifier=dets[0], **kw),
            JM.StreamMonitor(b"", verifier=dets[1], **kw))


def test_monitor_emits_authentic_windows(key32, dets):
    wm = compat_stream(key32, 8, seed=1)
    feeds = [wm[i:i + 4096] for i in range(0, wm.size, 4096)]
    got, want = run_monitors(
        compat_monitors(dets, window_s=4.0, hop_s=2.0), feeds)
    assert_events_equal(got, want, hop=hop_schedule(key32))
    assert len(got) == 3 and all(ev.result.authentic for ev in got)
    assert [ev.t_start for ev in got] == pytest.approx([0.0, 2.0, 4.0])
    ctrs = [ev.result.frame_ctr for ev in got]
    assert ctrs == sorted(ctrs) and ctrs[-1] > ctrs[0]


def test_monitor_rejects_foreign_session_mid_stream(key32, dets):
    """The anti-replay latch persists across windows."""
    wm1 = compat_stream(key32, 4, seed=2)
    wm2 = compat_stream(key32, 4, seed=4)         # another session nonce
    pm, jm = compat_monitors(dets, window_s=4.0, hop_s=4.0)
    ev_p, ev_j = pm.feed(wm1), jm.feed(wm1)
    assert_events_equal(ev_p, ev_j, hop=hop_schedule(key32))
    assert ev_p and ev_p[0].result.authentic
    assert pm.session_nonce == jm.session_nonce is not None
    ev_p, ev_j = pm.feed(wm2), jm.feed(wm2)
    assert_events_equal(ev_p, ev_j)
    assert ev_p and not ev_p[0].result.authentic


def test_monitor_plain_noise_quiet(dets, rng):
    noise = (0.05 * rng.standard_normal(int(4.5 * FS))).astype(np.float32)
    got, want = run_monitors(
        compat_monitors(dets, window_s=4.0, hop_s=2.0), [noise])
    assert_events_equal(got, want)
    assert len(got) == 1 and not got[0].result.authentic
    assert (got[0].t_start, got[0].t_end) == (0.0, 4.0)


def test_monitor_v2_profile(key32):
    wm = v2_stream(key32, 7, seed=3, level=0.0)
    kw = dict(profile="v2", window_s=4.0, hop_s=2.0)
    jm = JM.StreamMonitor(key32, **kw)
    pm = PM.StreamMonitor(key32, verifier=RobustVerifier.from_tables(
        key32, numpy_tables_of(jm._det, VERIFIER_TABLE_DTYPES), device="cpu"),
        **kw)
    got, want = run_monitors((pm, jm), [wm])
    # v2 results carry no session nonce; the latch is on the verifier
    assert_events_equal(got, want, FIELDS[:-1] + ("timescale",))
    assert len(got) == 3 and all(ev.result.authentic for ev in got)
    assert got[-1].t_end == 7.0                 # the flushed 3 s remainder
    assert pm.session_nonce == jm.session_nonce is not None


def test_monitor_argument_checks(key32):
    for cls in (PM.StreamMonitor, PM.BatchStreamMonitor):
        with pytest.raises(ValueError):
            cls(key32, window_s=2.0, hop_s=3.0, device="cpu")
    det = WatermarkDetector(key32, list_size=4, device="cpu")
    mon = PM.StreamMonitor(key32, verifier=det)
    assert mon._det is det and mon.flush() == []
    assert (PM.BatchStreamMonitor.MAX_ROWS, mon.window, mon.hop) == (
        JM.BatchStreamMonitor.MAX_ROWS, 4 * FS, 2 * FS)


# ------------------------------------------------------- BatchStreamMonitor
@pytest.fixture(scope="module")
def batch_verifiers(key32):
    jv = JPL.RobustBatchVerifier(key32, max_ctr=4096)
    pv = PP.RobustBatchVerifier.from_tables(
        key32, numpy_tables_of(jv, V2_TABLE_DTYPES), device="cpu")
    return jv, pv


def _in_window(ev) -> bool:
    span = FRAME_LEN * 8
    return (ev.t_start * FS - span) / span <= ev.result.frame_ctr \
        <= ev.t_end * FS / span


def test_batch_monitor_serving_tier(key32, batch_verifiers):
    jv, pv = batch_verifiers
    wm = v2_stream(key32, 12, seed=5, nonce=b"monitorA")
    feeds = [wm[i:i + 3 * FS] for i in range(0, wm.size, 3 * FS)]
    kw = dict(window_s=4.0, hop_s=2.0)
    got, want = run_monitors(
        (PM.BatchStreamMonitor(key32, verifier=pv, **kw),
         JM.BatchStreamMonitor(key32, verifier=jv, **kw)), feeds)
    assert_events_equal(got, want, ("authentic", "stage", "frame_ctr",
                                    "session_nonce"))
    assert len(got) >= 4 and all(ev.result.authentic for ev in got)
    assert all(ev.result.session_nonce == b"monitorA" for ev in got)
    assert all(_in_window(ev) for ev in got + want)
    assert pv.tables["templates"].shape[-1] == 504
    assert PM.BatchStreamMonitor(key32, verifier=pv)._tpad == 4 * FS + 16384

    # expected_nonce pins the session: a foreign-session stream rejects
    wm2 = v2_stream(key32, 6, seed=6, nonce=b"monitorB")
    got, want = run_monitors(
        (PM.BatchStreamMonitor(key32, verifier=pv, expected_nonce=b"monitorA",
                               **kw),
         JM.BatchStreamMonitor(key32, verifier=jv, expected_nonce=b"monitorA",
                               **kw)), [wm2])
    assert_events_equal(got, want, ("authentic", "stage"))
    assert got and not any(ev.result.authentic for ev in got)
    assert all(ev.result.stage == "batch" for ev in got)


def test_batch_monitor_chunked_dispatch(key32, batch_verifiers, monkeypatch):
    """One feed over many windows is split at MAX_ROWS rows per batch."""
    _, pv = batch_verifiers
    wm = v2_stream(key32, 10, seed=7, nonce=b"monitorC")
    ref_mon = PM.BatchStreamMonitor(key32, verifier=pv)
    ref = ref_mon.feed(wm) + ref_mon.flush()
    calls = []
    orig = pv.verify_batch

    def counted(batch, nv, **kw):
        calls.append(batch.shape)
        return orig(batch, nv, **kw)

    monkeypatch.setattr(pv, "verify_batch", counted)
    monkeypatch.setattr(PM.BatchStreamMonitor, "MAX_ROWS", 2)
    mon = PM.BatchStreamMonitor(key32, verifier=pv)
    got = mon.feed(wm) + mon.flush()
    assert_events_equal(got, ref, ("authentic", "stage", "frame_ctr",
                                   "session_nonce"))
    assert len(got) >= 4 and all(e.result.authentic for e in got)
    # exactly the completed windows go up, never zero-row padding
    assert calls[:2] == [(2, mon._tpad), (2, mon._tpad)]
    assert sum(c[0] for c in calls) == len(got)


# ------------------------------------------------------------- VerifierPool
def _pool_clips(key, seed, n=2):
    be = BatchEmbedder(key, device="cpu")
    T = 3 * FS
    n_frames = -(-T // FRAME_LEN)
    scale = 10.0 ** (be.p.floor_rel_dbfs / 20.0)
    clips = np.zeros((n, 1 << 18), np.float32)
    rng = np.random.default_rng(seed)
    for i in range(n):
        fr = be.frames(np.arange(i * 7, i * 7 + n_frames),
                       session_nonce=bytes(8), rng=rng)
        clips[i, :T] = fr.reshape(-1)[:T] * scale
    return clips, np.full(n, T, np.int32)


@pytest.fixture(scope="module")
def pool_clips():
    return _pool_clips(KEY_A, 1), _pool_clips(KEY_B, 2)


def test_pool_per_key_isolation(pool_clips):
    (ca, nva), (cb, nvb) = pool_clips
    pool = VerifierPool(max_keys=4, max_ctr=2048, device="cpu")
    jpool = JPool(max_keys=4, max_ctr=2048)
    for key, clips, nv in ((KEY_A, ca, nva), (KEY_B, cb, nvb),
                           (KEY_B, ca, nva)):      # last: cross-key
        got = pool.verify(key, clips, nv)
        assert got.tolist() == jpool.verify(key, clips, nv).tolist()
        assert got.all() == (clips is not ca or key == KEY_A)
    assert pool.cached_keys == jpool.cached_keys == [KEY_A, KEY_B]
    assert pool.get(KEY_A) is pool.get(KEY_A)
    assert pool.cached_keys == [KEY_B, KEY_A]      # most recent last
    assert pool.get(KEY_A).device.type == "cpu"


def test_pool_lru_eviction_still_correct(pool_clips):
    (ca, nva), (cb, nvb) = pool_clips
    pool = VerifierPool(max_keys=1, max_ctr=2048, device="cpu")
    assert pool.verify(KEY_A, ca, nva).all()
    first = pool.get(KEY_A)
    assert pool.verify(KEY_B, cb, nvb).all()       # evicts A
    assert pool.cached_keys == [KEY_B]
    assert pool.verify(KEY_A, ca, nva).all()       # rebuilt transparently
    assert pool.cached_keys == [KEY_A] and pool.get(KEY_A) is not first
    assert not pool.verify(KEY_A, ca, nva, expected_nonce=b"othersss").any()


def test_pool_argument_checks_and_v2(pool_clips, monkeypatch):
    (ca, nva), _ = pool_clips
    with pytest.raises(ValueError):
        VerifierPool(profile="v3")
    with pytest.raises(ValueError):
        VerifierPool(max_keys=0)
    pool = VerifierPool(max_keys=1, max_ctr=64, device="cpu")
    with pytest.raises(ValueError, match="v2"):
        pool.verify(KEY_A, ca, nva, recover_timescale=True)
    torch.backends.cudnn.allow_tf32 = True
    v2 = VerifierPool(profile="v2", max_keys=1, max_ctr=64, device="cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert isinstance(v2.get(KEY_A), PP.RobustBatchVerifier)
    called = {}
    monkeypatch.setattr(
        PP.RobustBatchVerifier, "verify_batch_recover",
        lambda self, clips, nv, expected_nonce=None: called.setdefault(
            "nonce", expected_nonce) or np.zeros(len(clips), bool))
    v2.verify(KEY_A, ca[:, :1 << 16], None, expected_nonce=b"sessionA",
              recover_timescale=True)
    assert called == {"nonce": b"sessionA"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VerifierPool(max_ctr=64).get(KEY_A)


def test_pool_threads_keep_the_bound_and_the_keys(monkeypatch):
    """More threads than cores hammer ``get``: the cache never outgrows
    ``max_keys`` and every verifier handed out was built for its key."""
    import sys
    import threading

    import echoseal_torch.models.service as service

    class Stub:
        def __init__(self, key32, **kw):
            self.key = key32

    monkeypatch.setattr(service, "BatchVerifier", Stub)
    pool = VerifierPool(max_keys=2, device="cpu")
    keys = [bytes([i]) * 32 for i in range(5)]
    bad, stop = [], threading.Event()

    def worker(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            k = keys[int(rng.integers(len(keys)))]
            if pool.get(k).key != k or len(pool.cached_keys) > 2:
                bad.append(k)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    try:
        for t in threads:
            t.start()
        stop.wait(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == [] and len(pool.cached_keys) <= 2


# ------------------------------------------------------ session checkpoints
def test_tx_checkpoint_resume_and_cross_package(tmp_path, key32):
    tx = WatermarkEmbedder(key32, rng=np.random.default_rng(8))
    tx.process(np.zeros(2000, np.float32))
    p = tmp_path / "tx.json"
    session.save_tx(tx, p)
    tx2 = WatermarkEmbedder(key32)
    session.load_tx(tx2, p)
    jtx = JEmbedder(key32)
    j_session.load_tx(jtx, p)                    # port checkpoint -> JAX TX
    for other in (tx2, jtx):
        assert other.frame_ctr == tx.frame_ctr == 2
        assert other._session_nonce == tx._session_nonce
        np.testing.assert_array_equal(other._chip_buf, tx._chip_buf)
    jtx.process(np.zeros(700, np.float32))
    back = tmp_path / "jtx.json"
    j_session.save_tx(jtx, back)                 # ... and back
    tx3 = RobustEmbedder(key32)
    session.load_tx(tx3, back)
    assert tx3.frame_ctr == jtx.frame_ctr
    np.testing.assert_array_equal(tx3._chip_buf, jtx._chip_buf)
    with pytest.raises(ValueError):
        session.load_rx(tx3, back)


def test_rx_checkpoint_resume_and_cross_package(tmp_path, key32):
    det = WatermarkDetector(key32, list_size=8, device="cpu")
    p = tmp_path / "rx.json"
    for nonce in (b"12345678", None):
        det.session_nonce = nonce
        session.save_rx(det, p)
        det2 = WatermarkDetector.from_tables(
            key32, {k: v.numpy() for k, v in det.tables.items()},
            device="cpu")
        det2.session_nonce = b"stalestale"[:8]
        session.load_rx(det2, p)
        jdet = JDetector(key32, list_size=8)
        j_session.load_rx(jdet, p)
        assert det2.session_nonce == jdet.session_nonce == nonce
        j_session.save_rx(jdet, p)
        session.load_rx(det, p)
        assert det.session_nonce == nonce
    with pytest.raises(ValueError):
        session.load_tx(det, p)


def test_structured_logger_timer_and_trace(caplog):
    from echoseal_torch.utils.logging import Timer, get_logger, tracing

    log = get_logger("unit", min_interval_s=60.0)
    with caplog.at_level(logging.DEBUG, logger="echoseal"):
        log.event("x", a=1)
        log.event("x", a=2)              # rate-limited away
        log.info("y", b=b"\x00")
    assert [r.getMessage() for r in caplog.records] == [
        'x {"a": 1}', 'y {"b": "b\'\\\\x00\'"}']
    with Timer("unit") as t:
        pass
    assert t.elapsed >= 0.0 and Timer.report()["unit"]["n"] >= 1
    acts = [torch.profiler.ProfilerActivity.CPU]
    with tracing() as tr, torch.profiler.profile(activities=acts) as prof:
        with Timer("unit_span"):
            assert torch.ones(2).sum() == 2
    assert [s["name"] for s in tr.spans] == ["unit_span"]
    assert "unit_span" in {e.key for e in prof.key_averages()}
