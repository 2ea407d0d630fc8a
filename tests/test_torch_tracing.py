"""The port's spans (``echoseal_torch.utils.logging``): the span tree of
one compat and one v2 ``verify_batch`` call, the bounded registry, the
trace's cap, the shared clock with ``torch.profiler``, ``scl_rungs``
after a call without a rung, and the benchmark's readers of the spans.

The verifiers are the port's own, on the CPU, built once per module; the
clips come from the port's seeded TX as in ``test_torch_pipeline.py``
and ``test_torch_robust.py`` (the v2 silence + AWGN clip is rescued by
the SCL ladder, the loud-host clip by the hard pass).
"""
import importlib

import numpy as np
import pytest
import torch

from echoseal_torch.core.params import FRAME_LEN
from echoseal_torch.models import pipeline as PP
from echoseal_torch.models import robust as probust
from echoseal_torch.models.embedder import frames_np
from echoseal_torch.utils import logging as plog
from echoseal_torch.utils.logging import Timer, tracing
from torch_port_util import two_torch_threads  # noqa: F401

FS = 48_000
TPAD = 1 << 18
MAX_CTR = 4096


def _by_id(spans):
    return {s["id"]: s for s in spans}


def _root_of(span, ids):
    while span["parent"] is not None:
        span = ids[span["parent"]]
    return span


def _check_tree(spans, verdicts):
    """One call, every chain ends at its root ``verify_batch``, the opens'
    ``accepts`` add up to the accepted clips; returns the root."""
    ids = _by_id(spans)
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["verify_batch"]
    root = roots[0]
    assert {s["call"] for s in spans} == {root["id"]}
    assert all(_root_of(s, ids) is root for s in spans)
    for s in spans:
        assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= root["end_ns"]
        if s["name"].endswith(".download"):
            assert s["attrs"].get("bytes", 0) >= 0
    opens = [s for s in spans if s["name"].endswith(".open")]
    assert sum(s["attrs"]["accepts"] for s in opens) == int(verdicts.sum())
    assert root["attrs"] == {"clips": len(verdicts),
                             "accepts": int(verdicts.sum())}
    assert all(s["attrs"]["opens"] >= s["attrs"]["blobs"] for s in opens)
    return root


# --------------------------------------------------------------- compat
@pytest.fixture(scope="module")
def compat(key32):
    """4 compat clips: two clean, one past the PN table, one of noise."""
    pv = PP.BatchVerifier(key32, max_ctr=MAX_CTR, device="cpu")
    T = 3 * FS
    n_frames = -(-T // FRAME_LEN)
    clips = np.zeros((4, TPAD), np.float32)
    rng = np.random.default_rng(4)
    for i, start in enumerate((120, 2000, 70_000)):
        fr = frames_np(pv.sec, pv._hop, np.arange(start, start + n_frames),
                       b"tracesss", rng=rng)
        clips[i, :T] = fr.reshape(-1)[:T] * 10.0 ** (-35.0 / 20.0)
    clips[3, :T] = 0.02 * rng.standard_normal(T)
    return pv, clips, np.full(4, T, np.int32)


def test_compat_call_span_tree(compat):
    pv, clips, nv = compat
    details = {}
    with tracing() as tr:
        v = pv.verify_batch(clips, nv, details=details)
    spans = tr.drain()
    assert v.tolist() == [True, True, True, False]
    assert details[2].stage == "ext_ctr"
    _check_tree(spans, v)
    names = {s["name"] for s in spans}
    assert {"verify.device", "verify.download", "verify.open",
            "verify.ext_ctr", "ext_ctr.download",
            "ext_ctr.open"} <= names
    ids = _by_id(spans)
    for s in spans:
        if s["name"].startswith("ext_ctr."):
            assert ids[s["parent"]]["name"] == "verify.ext_ctr"
    hard = [s for s in spans if s["name"] == "verify.open"]
    assert [s["attrs"]["accepts"] for s in hard] == [2]
    dl = [s for s in spans if s["name"] == "verify.download"]
    assert [s["attrs"]["bytes"] for s in dl] == [4 * 60]
    assert tr.spans == [] and tr.dropped == 0


# ------------------------------------------------------------------- v2
@pytest.fixture(scope="module")
def v2(key32):
    """The port's v2 verifier and 3.5 s clips: loud tone host (hard pass),
    silence + AWGN at +4 dB (SCL ladder), noise (futility gate)."""
    pv = PP.RobustBatchVerifier(key32, max_ctr=MAX_CTR, device="cpu")
    T = int(3.5 * FS)
    host = (0.15 * np.sin(2 * np.pi * 700 * np.arange(T) / FS)
            ).astype(np.float32)
    tx_loud = probust.RobustEmbedder(key32, rng=np.random.default_rng(0))
    tx_loud._session_nonce = b"sessionA"
    tx_sil = probust.RobustEmbedder(key32, rng=np.random.default_rng(1))
    tx_sil._session_nonce = b"sessionB"
    wm_sil = tx_sil.process(np.zeros(T, np.float32))
    rms = float(np.sqrt(np.mean(wm_sil ** 2)))
    rng = np.random.default_rng(3)
    clips = np.zeros((3, TPAD), np.float32)
    clips[0, :T] = tx_loud.process(host)
    clips[1, :T] = wm_sil + rms * 10 ** (-4 / 20) * rng.standard_normal(
        T).astype(np.float32)
    clips[2, :T] = 0.05 * rng.standard_normal(T).astype(np.float32)
    return pv, clips, np.full(3, T, np.int32)


@pytest.fixture(scope="module")
def v2_ladder_call(v2):
    """One traced v2 call that climbs the ladder: (verdicts, spans,
    scl_rungs)."""
    pv, clips, nv = v2
    details = {}
    with tracing() as tr:
        v = pv.verify_batch(clips, nv, details=details)
    assert details[1].stage == "scl"
    return v, tr.drain(), list(pv.scl_rungs)


def test_v2_call_span_tree(v2_ladder_call):
    v, spans, rungs = v2_ladder_call
    assert v.tolist() == [True, True, False]
    _check_tree(spans, v)
    ids = _by_id(spans)

    def named(n):
        return [s for s in spans if s["name"] == n]

    parent = {s["name"]: ids[s["parent"]]["name"] for s in spans
              if s["parent"] is not None}
    assert parent["verify.device"] == parent["verify.download"] \
        == parent["verify.gate"] == parent["verify.ladder"] == "verify_batch"
    assert parent["gate.download"] == "verify.gate"
    assert parent["ladder.rung"] == "verify.ladder"
    for n in ("ladder.decode", "ladder.open"):
        assert parent[n] == "ladder.rung"
    (ladder,) = named("verify.ladder")
    assert ladder["attrs"] == {"rows": 1, "rescued": 1}
    rung_spans = named("ladder.rung")
    assert len(rung_spans) == len(rungs) >= 1
    assert [(s["attrs"]["rows"], s["attrs"]["list_size"])
            for s in rung_spans] == [(n, L) for _, L, n, _ in rungs]
    assert sum(s["attrs"]["rescued"] for s in rung_spans) == 1
    assert named("verify.gate")[0]["attrs"]["rows"] == 1
    assert len(named("ladder.decode")) == len(rung_spans)
    # no CUDA events on the CPU: nothing to resolve
    assert all("dev_ms" not in s["attrs"] for s in spans)


def test_scl_rungs_describe_the_last_call(v2, v2_ladder_call):
    """After a call that climbs the ladder, a call that reaches no rung
    leaves ``scl_rungs`` empty."""
    pv, clips, nv = v2
    assert v2_ladder_call[2]
    with tracing() as tr:
        v = pv.verify_batch(clips[[0, 2]], nv[[0, 2]])
    assert v.tolist() == [True, False]
    assert pv.scl_rungs == []
    spans = tr.drain()
    _check_tree(spans, v)
    assert not any(s["name"].startswith("ladder.") for s in spans)


# ------------------------------------------------------- the primitive
def test_no_trace_records_nothing_and_registry_is_bounded():
    with tracing() as tr:
        with Timer("unit.traced"):
            pass
    assert len(tr.spans) == 1
    Timer.registry.pop("unit.bounded", None)
    for _ in range(5000):
        with Timer("unit.bounded", rows=1) as t:
            pass
    assert t.id is None
    assert len(tr.spans) == 1
    assert len(Timer.registry["unit.bounded"]) == plog.REGISTRY_LEN == 4096
    assert Timer.report()["unit.bounded"]["n"] == 4096


def test_trace_keeps_its_cap_and_counts_the_rest(monkeypatch):
    assert plog.TRACE_CAP == 1 << 20
    monkeypatch.setattr(plog, "TRACE_CAP", 3)
    with tracing() as tr:
        with Timer("outer"):
            for _ in range(4):
                with Timer("inner"):
                    pass
    assert [s["name"] for s in tr.spans] == ["inner"] * 3
    assert tr.dropped == 2
    assert len({s["parent"] for s in tr.spans}) == 1


def test_span_on_the_profiler_clock():
    """A span opened inside a ``torch.profiler`` session shows there as a
    ``record_function`` of its name, stamped on the span's own clock."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with tracing() as tr, torch.profiler.profile(activities=acts) as prof:
        with Timer("unit.profiled"):
            torch.ones(4).sum()
    (span,) = tr.spans
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "unit.profiled"]
    assert len(starts) == 1
    assert abs(starts[0] - span["start_ns"]) < 2_000_000


# ------------------------------------------- the benchmark's readers
def _reader(name):
    return importlib.import_module(f"portbench.metrics.{name}").read


class _Runner:
    """The one call a program-span pass makes on a one-batch cell."""

    def __init__(self, pv, clips, nv):
        self.pv, self.clips, self.nv = pv, clips, nv
        self.batches = [None]

    def call(self, i):
        return self.pv.verify_batch(self.clips, self.nv)


@pytest.fixture
def one_pass(monkeypatch):
    from portbench import trace

    monkeypatch.setattr(trace, "PROFILE_S", 0.0)


def test_readers_of_the_program_spans(v2, one_pass):
    pv, clips, nv = v2
    ctx = {"runner": _Runner(pv, clips, nv)}
    vals = {n: _reader(n)(ctx) for n in (
        "host_wait_ms", "aead_open_ms", "ladder_call_ms",
        "ladder_rows_per_rescue")}
    prog = ctx["program"]
    assert prog["calls"] == 1
    (root,) = [s for s in prog["spans"] if s["name"] == "verify_batch"]
    call_ms = 1e-6 * (root["end_ns"] - root["start_ns"])
    assert 0 < vals["host_wait_ms"] + vals["aead_open_ms"] < call_ms
    assert 0 < vals["ladder_call_ms"] < call_ms
    rows = sum(s["attrs"]["rows"] for s in prog["spans"]
               if s["name"] == "ladder.rung")
    assert vals["ladder_rows_per_rescue"] == rows >= 1
    # a window that rescued nothing: no ladder, no rows per rescue
    ctx = {"runner": _Runner(pv, clips[[0, 2]], nv[[0, 2]])}
    assert _reader("ladder_call_ms")(ctx) == 0.0
    assert _reader("ladder_rows_per_rescue")(ctx) is None


def test_readers_without_program_tracing(v2, one_pass, monkeypatch):
    """A program without ``tracing`` (the parent of this benchmark's
    program-span metrics) reads None and makes no call."""
    monkeypatch.delattr(plog, "tracing")
    ctx = {"runner": None}
    for n in ("host_wait_ms", "aead_open_ms", "ladder_call_ms",
              "ladder_rows_per_rescue"):
        assert _reader(n)(ctx) is None
