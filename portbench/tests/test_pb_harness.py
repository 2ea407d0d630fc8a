"""The harness finds everything by name, its generator is deterministic in
the seed, and its arithmetic (a rate over the whole window, the 95th
percentile of all requests, an idle share from a kernel timeline, a
roofline share) is what the metrics say."""
from __future__ import annotations

import json
import shutil
import statistics

import numpy as np
import pytest

from portbench import gen, harness, peaks, trace
from portbench.tests.pb_fixtures import (  # noqa: F401
    SINGLE, single_root, two_threads)

WORKLOADS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SMALL = {"clips": 3, "batches": 2}


@pytest.mark.parametrize("name", WORKLOADS + [SINGLE])
def test_every_cell_resolves(name, single_root):
    root = single_root if name == SINGLE else harness.ROOT
    cell = harness.load_cell(name, root)
    assert cell["traffic"]["entry"] in ("batch", "single")
    assert set(cell["limits"]) >= {"verdict_mismatch", "untrue_accept"}
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
    for m in cell["per_layer"]:
        assert callable(harness.metric_reader(m["name"], root))
        assert m["moves"] in {e["name"] for e in cell["end_to_end"]}


def test_cell_added_as_files_only(tmp_path):
    """A new cell is a traffic file, a limits file and an entry."""
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "compat.batch-short", "config": "compat",
                              "traffic": "batch-short", "chips": 1,
                              "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "portbench" / "traffic" / "batch-short.json").write_text(
        json.dumps({"entry": "batch", "clips": 8, "clip_s": 3.0,
                    "batches": 1, "channel": None}))
    shutil.copy(tmp_path / "portbench" / "limits" / "compat.batch-clean.json",
                tmp_path / "portbench" / "limits" / "compat.batch-short.json")
    cell = harness.load_cell("compat.batch-short", root=tmp_path)
    assert cell["traffic"]["clips"] == 8
    assert cell["config"]["waveform"] == "compat"
    assert [m["name"] for m in cell["per_layer"]] == []   # listed per cell
    with pytest.raises(SystemExit):
        harness.load_cell("compat.nothing", root=tmp_path)


@pytest.mark.parametrize("name", ["compat.batch-clean", "v2.batch-mp3"])
def test_generator_deterministic_in_seed(name):
    cell = harness.load_cell(name)
    cfg = dict(cell["config"], tx=dict(cell["config"]["tx"]))
    if "stream_frames" in cfg["tx"]:
        cfg["tx"]["stream_frames"] = 160
    else:
        cfg["tx"]["stream_s"] = 8.0
    tr = dict(cell["traffic"], **SMALL)
    seed = 2 ** 31 + 12345                   # past 32 signed bits
    s1, b1 = gen.make_batches(cfg, tr, seed, "cpu")
    s2, b2 = gen.make_batches(cfg, tr, seed, "cpu")
    s3, b3 = gen.make_batches(cfg, tr, seed + 1, "cpu")
    assert s1.nonce == s2.nonce and np.array_equal(s1.samples, s2.samples)
    for x, y, z in zip(b1, b2, b3):
        assert np.array_equal(x.clips.numpy(), y.clips.numpy())
        assert np.array_equal(x.starts, y.starts)
        assert x.clips.shape == z.clips.shape and x.seconds == z.seconds
    assert not np.array_equal(b1[0].starts, b3[0].starts)


class _Fake:
    """A runner whose calls take a fixed, known time."""

    def __init__(self, dt):
        self.dt, self.now = dt, 0.0

    def call(self, i):
        self.now += self.dt[i % len(self.dt)]
        return (0, np.ones(2, bool), {})

    def work(self, b):
        return 6.0


def test_rate_is_all_work_over_all_time(monkeypatch):
    fake = _Fake([0.1, 0.3])
    monkeypatch.setattr(harness.time, "perf_counter", lambda: fake.now)
    win = harness.window(fake, 1.0)
    # calls until 1 s has passed: 0.1+0.3+0.1+0.3+0.1+0.3 = 1.2 s, 6 calls
    assert win["calls"] == 6 and win["window_s"] == pytest.approx(1.2)
    vals = harness.end_to_end(["audio_s_per_s", "setup_s"], win, 3.0)
    assert vals["audio_s_per_s"] == pytest.approx(36.0 / 1.2)
    assert vals["setup_s"] == 3.0


def test_p95_of_all_requests():
    lat = [i / 1000 for i in range(1, 201)]        # 1..200 ms
    win = {"latencies": lat}
    vals = harness.end_to_end(["clip_p50_ms", "clip_p95_ms"], win, 0.0)
    assert vals["clip_p50_ms"] == pytest.approx(100.5)
    want = statistics.quantiles(lat, n=100, method="exclusive")[94] * 1e3
    assert vals["clip_p95_ms"] == pytest.approx(want)
    assert 190.0 < vals["clip_p95_ms"] < 191.0


def test_idle_share_from_kernel_timeline():
    dev = [(100, 300, "a"), (200, 400, "b"), (600, 700, "a"), (900, 1200, "c")]
    cpu = [(0, 1100, "portbench.verify_batch"), (450, 550, "aten::copy_")]
    s = trace.summarize(dev, cpu, 0, 1000)
    # busy: [100, 400] + [600, 700] + [900, 1000] = 500 of 1000 ns
    assert s["busy_s"] == pytest.approx(500e-9)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["idle_pct"] == pytest.approx(50.0)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["a"] == pytest.approx(300e-9)
    assert ops["c"] == pytest.approx(100e-9)
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0] == ["aten::copy_", pytest.approx(200e-9)]
    assert sorted(g[1] for g in gaps) == pytest.approx(
        [100e-9, 200e-9, 200e-9])


def test_roofline_share():
    flops, nbytes = peaks.ls_demod_work(1024, 4, 9720)
    assert flops == 2.0 * 4 * 4096 * 9720 * 2430
    t = flops / peaks.FP32_FLOPS
    assert peaks.roofline_pct(flops, nbytes, 2 * t) == pytest.approx(50.0)
