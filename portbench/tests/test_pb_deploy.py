"""A new deployment joins the benchmark as new files and entries only: a
runner (``portbench/runners/``), a host (``hosts/``), a channel
(``channels/``), a configuration, a traffic mix and a limits file, all
from ``portbench/tests/deploy/``, in a copy of the checkout whose
harness and generator stay as they are.  Its cell runs ``correct`` on the
CPU at a small size."""
from __future__ import annotations

import json
import shutil
import time

import numpy as np
import pytest

from portbench import gen, harness
from portbench.tests.pb_fixtures import two_threads  # noqa: F401

DEPLOY = harness.PKG / "tests" / "deploy"
CELL = "v2-chirp.batch-gain"
SEED = 2 ** 31 + 4242


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    """A copy of the checkout with the deployment's files added."""
    root = tmp_path_factory.mktemp("deployed")
    shutil.copytree(harness.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src in sorted(p for p in DEPLOY.rglob("*") if p.parent != DEPLOY):
        dst = root / "portbench" / src.relative_to(DEPLOY)
        assert not dst.exists(), f"{dst} is not a new file"
        shutil.copy(src, dst)
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    add = json.loads((DEPLOY / "entries.json").read_text())
    spec["configs"] += add["configs"]
    spec["workloads"] += add["workloads"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.get("workloads", []).extend(add["reported_by"].get(m["name"], []))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_harness_and_generator_untouched(deployed):
    for name in ("harness.py", "gen.py", "calibrate.py", "run.py"):
        assert (deployed / "portbench" / name).read_bytes() == \
            (harness.PKG / name).read_bytes()


def test_host_and_channel_found_under_the_root(deployed):
    cell = harness.load_cell(CELL, deployed)
    cfg, tr = cell["config"], dict(cell["traffic"], clips=2, batches=1)
    loud = dict(tr, channel=dict(tr["channel"], db=0.0))
    s, _ = gen.make_batches(cfg, tr, SEED, "cpu", deployed)
    s0, _ = gen.make_batches(cfg, loud, SEED, "cpu", deployed)
    assert s.fs == cfg["fs"] and s.nonce == s0.nonce
    np.testing.assert_array_equal(s.samples,
                                  s0.samples * np.float32(10 ** (-6 / 20)))
    with pytest.raises(ValueError, match="chirp"):
        gen.make_batches(cfg, tr, SEED, "cpu")     # this checkout has none


def test_deployment_runs_correct(deployed):
    out = harness.run(CELL, SEED, 0.5, False, t_start=time.perf_counter(),
                      device="cpu", overrides={"clips": 3, "batches": 2},
                      root=deployed)
    assert out["correct"], out["checks"]
    assert out["checks"]["n_valid_mismatch"] == {"value": 0, "limit": 0}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"audio_s_per_s", "setup_s"}
