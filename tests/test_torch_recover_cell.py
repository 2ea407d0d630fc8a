"""The benchmark cell ``v2.recover-timescale`` on the CPU at a small size:
``verify_batch_recover(details=)`` of the port against the plain recovery
reference ``portbench/ref/recover.py``, one planted fault per control of
the comparison, and a whole run of the cell through the harness.

The cell's own traffic: the seeded 60 s tone-host session of the v2
configuration, played 3.1 % fast, cut at any sample into 3.5 s clips.
One runner is built per module (the port's v2 tables and scan bank, the
reference's tables and bank are designed once); each test makes one
``verify_batch_recover`` call of its three clips and runs the cell's
comparison on it.
"""
import time

import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from echoseal_torch.models import robust
from echoseal_torch.ops import demod
from echoseal_torch.ops.resample import DeviceResampler
from portbench import harness
from portbench.ref import recover as ref
from portbench.ref.verify import round_tf32
from torch_port_util import two_torch_threads  # noqa: F401

CELL = "v2.recover-timescale"
SEED = 2 ** 31 + 72
SMALL = {"clips": 3, "batches": 1}


@pytest.fixture(scope="module")
def runner():
    _, r = harness.build(CELL, SEED, "cpu", SMALL)
    return r


def _checked(runner):
    """One call of the runner's batch and the comparison of it."""
    rec = runner.call(0)
    return rec, runner.check([rec])


def _over(nums, limits):
    return {k for k, v in nums.items() if k in limits and v > limits[k]}


def test_reference_resample_is_scipys():
    """The reference's float64 polyphase sum equals scipy's
    ``resample_poly`` at the retry lattice's rationals and the channel's."""
    x = np.random.default_rng(5).standard_normal((2, 20_000))
    for up, down in ((12_000, 11_639), (12_000, 12_371), (1000, 1031)):
        want = resample_poly(x, up, down, axis=-1)
        got = ref.resample(torch.from_numpy(x), up, down, want.shape[1])
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


def test_port_against_the_reference(runner):
    """Scan scores and picks, resampled rows, every stage, the verdicts
    and accepts (nonce, counter, stage, factor) hold to the limits; every
    clip is retried and accepted at a factor of the retry lattice."""
    limits = harness.load_cell(CELL)["limits"]
    (_, verdicts, accepts), nums = _checked(runner)
    assert not _over(nums, limits), nums
    assert nums["verdict_mismatch"] == nums["untrue_accept"] == 0
    assert nums["scan_factor_mismatch"] == nums["host_rows"] == 0
    assert verdicts.all()
    log = runner.verifier.recover_log
    assert log["retry_rows"] >= 3 and log["host_rows"] == 0
    assert log["dens"] and all(11_400 <= d <= 12_600 for d in log["dens"])
    for nonce, ctr, stage, factor in accepts.values():
        assert nonce == runner.stream.nonce and stage in ("hard", "scl")
        assert factor * runner.retry_up in log["dens"]


def test_recover_spans_and_counters(runner):
    """The span tree of one call and the counters on its root."""
    from echoseal_torch.utils.logging import tracing

    with tracing() as tr:
        runner.call(0)
    spans = tr.drain()
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "verify_batch_recover"
    log = runner.verifier.recover_log
    assert root["attrs"] == {"clips": 3, "accepts": 3,
                             "retry_rows": log["retry_rows"],
                             "dens": len(log["dens"]), "host_rows": 0}
    ids = {s["id"]: s for s in spans}
    parent = {s["name"]: ids[s["parent"]]["name"] for s in spans
              if s["parent"] is not None}
    for name in ("recover.first_pass", "recover.scan", "recover.round"):
        assert parent[name] == "verify_batch_recover"
    assert parent["recover.resample"] == "recover.round"
    rounds = [s for s in spans if s["name"] == "recover.round"]
    assert [s["attrs"]["depth"] for s in rounds] == list(range(len(rounds)))
    assert [s["attrs"]["rows"] for s in rounds] == [
        r["rows"] for r in log["rounds"]]
    assert sum(s["attrs"]["rows"] for s in rounds) == log["retry_rows"]
    assert sum(s["attrs"]["accepted"] for s in rounds) == 3
    (scan,) = [s for s in spans if s["name"] == "recover.scan"]
    assert scan["attrs"] == {"rows": 3, "chunks": 1}
    resample = [s for s in spans if s["name"] == "recover.resample"]
    assert sum(s["attrs"]["rows"] for s in resample) == log["retry_rows"]
    assert all(s["attrs"]["miss"] == 0 for s in resample)   # plans cached


def test_refinement_stays_on_the_device(runner, monkeypatch):
    """From a grid-edge factor that fails, the chained estimates past the
    edge resample on the device: the retry family spans every factor the
    refinement rounds reach, and no row takes the host path (which
    downloads the whole clip batch)."""
    v = runner.verifier
    b = runner.batches[0]
    nv = b.n_valid.numpy()
    monkeypatch.setattr(robust, "estimate_timescale_from_peaks",
                        lambda peaks, span: 0.99)
    monkeypatch.setattr(v, "_finish_ladder",
                        lambda out, *a, real, **k: np.zeros(real.shape, bool))
    tried = {}
    v._retry_scaled(None, nv, {0: 0.95}, np.zeros(3, bool), None, refine=2,
                    clips_dev=b.clips, nv_dev=nv, tried=tried)
    assert tried == {0: {11_400, 11_286, 11_173}}     # 0.95, x 0.99, x 0.99
    assert v.recover_log["host_rows"] == 0


# ------------------------------------------------- the controls as faults
def scan_bf16(runner, mp):
    """The scan's clips and bank in bfloat16."""
    scan = robust._scale_scan_batch

    def low(x, nv, bank, *a, **k):
        return scan(x.to(torch.bfloat16).float(), nv,
                    bank.to(torch.bfloat16).float(), *a, **k)

    mp.setattr(robust, "_scale_scan_batch", low)


def taps_bf16(runner, mp):
    """The resampler's taps in bfloat16."""
    plan = DeviceResampler._plan_dev

    def low(self, down):
        taps, off, s0 = plan(self, down)
        return taps.to(torch.bfloat16).float(), off, s0

    mp.setattr(DeviceResampler, "_plan_dev", low)


def products_tf32(runner, mp):
    """The LS-demod product's operands rounded to TF32 (the card's TF32
    products; the CPU has none)."""
    ls = demod.ls_demod
    mp.setattr(demod, "ls_demod",
               lambda win, m: ls(round_tf32(win), round_tf32(m)))


def refine_skipped(runner, mp):
    """No refinement round after the scan's factors."""
    v = runner.verifier
    retry = v._retry_scaled

    def once(*a, **k):
        return retry(*a, **dict(k, refine=0))

    mp.setattr(v, "_retry_scaled", once)


CONTROLS = [(scan_bf16, "scan_score_err"),
            (taps_bf16, "resample_rel_err"),
            (products_tf32, "chips_rel_err"),
            (refine_skipped, "rejected_pct")]


@pytest.mark.parametrize("fault,number", CONTROLS,
                         ids=[f.__name__ for f, _ in CONTROLS])
def test_control_breaks_its_limit(fault, number, runner, monkeypatch):
    limits = harness.load_cell(CELL)["limits"]
    fault(runner, monkeypatch)
    _, nums = _checked(runner)
    assert nums[number] > limits[number], nums


def test_cell_runs_correct():
    """The whole cell through the harness, as ``run.py`` runs it."""
    out = harness.run(CELL, SEED + 1, 0.5, False,
                      t_start=time.perf_counter(), device="cpu",
                      overrides={"clips": 2, "batches": 1})
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == set(harness.load_cell(CELL)["limits"])
    assert set(out["metrics"]) == {"setup_s"}     # no card, no card rate
