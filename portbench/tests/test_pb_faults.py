"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (set-up, window, comparison) on the
CPU at a small size, past the harness's look for a card, with one fault
planted in the program the window drives: half of each batch left out,
an answer altered where it is produced, the soft rows that the SCL ladder
decodes negated, given shifted counters or stored in bfloat16, or the
compat demod's refinement skipped.  A sound run at the same size comes
out correct.  The soft rows' control (the reference's LLRs in bfloat16)
runs here too; the TF32 control needs the card.  The single-clip cell,
which ``BENCHMARK.json`` no longer lists, runs from a copy that adds it.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.tests.pb_fixtures import (  # noqa: F401
    SINGLE, card, single_root, two_threads)

SMALL = {"compat.batch-clean": {"clips": 3, "batches": 2},
         "v2.batch-mp3": {"clips": 3, "batches": 2},
         SINGLE: {"pool": 3}}
CELLS = list(SMALL)


@pytest.fixture
def run_cell(single_root):
    def _run(name, fault=None, device="cpu", **kw):
        return harness.run(name, 2 ** 31 + 77, 0.5, False,
                           t_start=time.perf_counter(), device=device,
                           overrides=kw.pop("overrides", SMALL[name]),
                           fault=fault,
                           root=single_root if name == SINGLE
                           else harness.ROOT, **kw)
    return _run


def half_left_out(runner, mp):
    """Verify the first half of each batch; the rest never verifies."""
    v = runner.verifier
    orig = v.verify_batch

    def verify_batch(clips, n_valid, **kw):
        h = clips.shape[0] // 2
        out = np.zeros(clips.shape[0], bool)
        out[:h] = orig(clips[:h], n_valid[:h], **kw)
        return out

    v.verify_batch = verify_batch


def answer_altered(runner, mp):
    """The AEAD ladder hands back a session nonce with one byte changed."""
    v = runner.verifier
    orig = v._accept_blobs

    def accept(blobs, ctrs, expected_nonce):
        out = orig(blobs, ctrs, expected_nonce)
        return [None if n is None else bytes([n[0] ^ 1]) + n[1:] for n in out]

    v._accept_blobs = accept


def detector_answer_altered(runner, mp):
    """The single-clip AEAD ladder hands back an altered session nonce."""
    v = runner.verifier
    orig = v._accept

    def accept(info_bits, frame_ctr):
        n = orig(info_bits, frame_ctr)
        return None if n is None else bytes([n[0] ^ 1]) + n[1:]

    v._accept = accept


def _soft_rows(runner, change):
    """``change`` the soft rows of every stage output in place, where the
    program makes them: its ladder decodes what the check reads."""
    v = runner.verifier
    run = v.run_device

    def run_device(*a, **k):
        out = run(*a, **k)
        change(out)
        return out

    v.run_device = run_device


def soft_llr_negated(runner, mp):
    """The soft rows' LLRs come out with the wrong sign."""
    _soft_rows(runner, lambda o: o["scl_llr"].neg_())


def soft_ctr_shifted(runner, mp):
    """Each soft row carries the next frame's counter."""
    _soft_rows(runner, lambda o: o["scl_ctr"].add_(1))


def soft_rows_bf16(runner, mp):
    """The soft rows are kept in bfloat16."""
    _soft_rows(runner, lambda o: o["scl_llr"].copy_(
        o["scl_llr"].to(torch.bfloat16)))


def refine_skipped(runner, mp):
    """The compat demods hand on their raw LS chips, unrefined."""
    from echoseal_torch.ops import demod

    mp.setattr(demod, "refine_chips", lambda win, chips, *a, **k: chips)


VERDICTS = ("verdict_mismatch", "untrue_accept")
FAULTS = [("compat.batch-clean", half_left_out, VERDICTS),
          ("compat.batch-clean", answer_altered, VERDICTS),
          ("compat.batch-clean", refine_skipped, ("chips_rel_err_p50",)),
          ("v2.batch-mp3", half_left_out, VERDICTS),
          ("v2.batch-mp3", answer_altered, VERDICTS),
          ("v2.batch-mp3", soft_llr_negated, ("soft_llr_err",)),
          ("v2.batch-mp3", soft_ctr_shifted, ("soft_ctr_mismatch",)),
          ("v2.batch-mp3", soft_rows_bf16, ("soft_llr_err",)),
          (SINGLE, detector_answer_altered, VERDICTS),
          (SINGLE, refine_skipped, ("chips_rel_err_p50",))]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, run_cell):
    out = run_cell(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and list(out["checks"])[-1] is not None
    assert out["failed"] == 0


@pytest.mark.parametrize("name,fault,numbers", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f, _ in FAULTS])
def test_fault_is_not_correct(name, fault, numbers, monkeypatch, run_cell):
    out = run_cell(name, lambda runner: fault(runner, monkeypatch))
    assert not out["correct"]
    checks = out["checks"]
    assert any(checks[k]["value"] > checks[k]["limit"] for k in numbers), \
        checks
    if numbers == VERDICTS:          # wrong answers are failed operations
        assert 0 < out["failed"] <= out["attempted"]


def test_soft_rows_control_reads_above_limit(monkeypatch, run_cell):
    """The reference's soft rows computed in bfloat16, in the program's
    place, read above the limit that sound runs stay under."""
    monkeypatch.setattr(check, "LLR_CONTROL", True)
    monkeypatch.setattr(check, "DIAG", {})
    out = run_cell("v2.batch-mp3")
    assert out["correct"], out["checks"]
    limit = out["checks"]["soft_llr_err"]["limit"]
    assert min(check.DIAG["soft_llr_err_bf16"]) > limit


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, card, run_cell):
    """The program with TF32 products, on the card at 256 clips (a pool
    of 8 cuts for the single-clip cell)."""
    small = dict(SMALL[name], **({"pool": 8} if "pool" in SMALL[name]
                                 else {"clips": 256, "batches": 1}))
    assert run_cell(name, device=card, overrides=small)["correct"]
    out = run_cell(name, device=card, overrides=small, control=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not out["correct"], out["checks"]
