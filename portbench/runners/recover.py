"""``verify_batch_recover`` in a closed loop, one client, over the
traffic's distinct batches in turn (clips played at another speed), and
its comparison against the plain recovery reference ``ref/recover.py``.

Each call keeps every device stage the program ran (the first pass and
each retry round: its rows, lengths and outputs), each ladder with its
rungs, the scan's scores, and the rows and lattice keys of each round
(``recover_log``).  After the window the last call of each distinct batch
is worked out again, following the program: the first pass and the scan
from the clips alone, each retry round at the program's own factors and
on its own resampled rows, the deferred ladder on the first pass's
outputs.  The numbers (each held to ``limits/<workload>.json``):

- ``verdict_mismatch``, ``untrue_accept``, ``wrong`` as in ``check.py``,
  an accept being (session nonce, counter, stage, factor); an accept is
  untrue when its nonce is not the session's, or its frame does not start
  within the clip's span of the stream as played at the original speed
  (the cut's start and length times the channel's factor);
- ``rejected_pct``: the share of clips of every call the program rejected,
  in %: every cut carries whole frames, and the speed is the only change;
- ``scan_score_err``: the largest relative gap between a (clip, bank row)
  scan score and the reference's float64 score;
- ``scan_factor_mismatch``: clips whose best factor (the largest score over
  the bands) is not the reference's, where the reference's score at the
  program's pick lies under its best by more than twice the relative
  error ``scan_score_err``'s limit allows each score (a near-tie within
  the scores' rounding is no mismatch);
- ``resample_rel_err``: the largest relative distance (L2 over the row) of
  a retried row from the reference's float64 resample of its clip at the
  program's lattice rational; ``host_rows``: rows resampled on the host,
  which the reference does not follow;
- per device stage, ``check.py``'s ``sync_val_err``, ``chips_rel_err``,
  ``decode_mismatch``, ``soft_llr_err``, ``soft_ctr_mismatch``, and per
  ladder ``scl_mismatch``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check, gen
from portbench.harness import build_system, reference_tables, settings
from portbench.ref import recover as ref
from portbench.ref import verify as ref_verify
from portbench.ref.profiles import ROBUST

_CAP: dict = {}
_TABLES: dict = {}


def _hook(verifier) -> None:
    """Keep each call's device stages, ladders (with their rungs) and scan
    scores in ``_CAP`` while it holds their lists: the verifier's
    ``run_device`` and ``_finish_ladder``, the ladder's
    ``pipeline.scl_decode_serving`` and the scan's
    ``robust._scale_scan_batch``, each wrapped once."""
    from echoseal_torch.models import pipeline, robust

    if not hasattr(verifier, "_portbench_recover"):
        verifier._portbench_recover = True
        run, finish = verifier.run_device, verifier._finish_ladder

        def run_device(clips, n_valid=None, **k):
            out = run(clips, n_valid, **k)
            if "runs" in _CAP:
                _CAP["runs"].append(dict(rows=clips, nv=n_valid, out=out))
            return out

        def finish_ladder(*a, **k):
            if "ladders" in _CAP:
                _CAP["ladders"].append([])       # this ladder's rungs
            return finish(*a, **k)

        verifier.run_device = run_device
        verifier._finish_ladder = finish_ladder
    if not hasattr(pipeline.scl_decode_serving, "_portbench_recover"):
        decode = pipeline.scl_decode_serving

        def scl_decode_serving(llr, spec, list_size):
            res = decode(llr, spec, list_size)
            if _CAP.get("ladders"):
                _CAP["ladders"][-1].append((llr.shape[0], list_size, res))
            return res

        scl_decode_serving._portbench_recover = True
        pipeline.scl_decode_serving = scl_decode_serving
    if not hasattr(robust._scale_scan_batch, "_portbench_recover"):
        scan = robust._scale_scan_batch

        def scale_scan_batch(*a, **k):
            scores = scan(*a, **k)
            if "scan" in _CAP:
                _CAP["scan"].append(scores)
            return scores

        scale_scan_batch._portbench_recover = True
        robust._scale_scan_batch = scale_scan_batch


def tables(config: dict, device) -> dict:
    """The reference's tables, designed once a process and device."""
    k = (config["key_hex"], config["fs"],
         settings(config, "recover")["max_ctr"], str(device))
    if k not in _TABLES:
        _TABLES[k] = reference_tables(config, "recover", device)
    return _TABLES[k]


class RecoverCell:
    """A closed loop of ``verify_batch_recover`` calls, one client, over
    the traffic's distinct batches in turn."""

    entry = "recover"

    def __init__(self, cell: dict, seed: int, device, verifier=None) -> None:
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.device = device
        t0 = time.perf_counter()
        self.verifier = verifier or build_system(self.config, self.entry,
                                                 device)
        t1 = time.perf_counter()
        self.stream, self.batches = gen.make_batches(
            self.config, self.traffic, seed, device, cell["root"])
        self.setup_parts = {"verifier_s": t1 - t0,
                            "inputs_s": time.perf_counter() - t1}
        self.T = int(round(self.traffic["clip_s"] * self.stream.fs))
        # the stream as played is the original one this many times faster
        self.speed = float(self.traffic["channel"]["factor"])
        self.retry_up = self.verifier.RETRY_UP
        # a scan pick this near (relative) the reference's best is a tie
        self.tie = 2 * cell["limits"]["scan_score_err"]
        self.captures: dict[int, dict] = {}
        _hook(self.verifier)

    def call(self, i: int):
        """One request: batch ``i % batches``; returns (batch, verdicts,
        accepts) and keeps what the call ran as that batch's."""
        b = i % len(self.batches)
        batch = self.batches[b]
        _CAP.clear()
        _CAP.update(runs=[], ladders=[], scan=[])
        details: dict = {}
        with torch.profiler.record_function("portbench.verify_batch_recover"):
            verdicts = self.verifier.verify_batch_recover(
                batch.clips, batch.n_valid, details=details)
        rounds = [{k: r[k] for k in ("clips", "keys", "host_rows")}
                  for r in self.verifier.recover_log["rounds"]]
        self.captures[b] = dict(_CAP, rounds=rounds)
        _CAP.clear()
        accepts = {i: (d.session_nonce, int(d.frame_ctr), d.stage,
                       float(d.factor)) for i, d in details.items()}
        return b, np.asarray(verdicts, bool), accepts

    def warm_up(self) -> None:
        for i in range(len(self.batches)):
            self.call(i)

    def work(self, b: int) -> float:
        return self.batches[b].seconds

    def free_program(self) -> None:
        """Drop the program's tables, scan bank and resampler plans; the
        captured stages stay."""
        v = self.verifier
        v.tables = None
        v._scan_bank = None
        v._resamplers = {}

    def sync_rows(self):
        for b in self.batches:
            yield b.clips, b.n_valid

    # ------------------------------------------------------- the comparison
    def check(self, records: list) -> dict:
        """Every comparison number of the cell (after the window)."""
        tab = tables(self.config, self.device)
        st = settings(self.config, self.entry)
        bank = torch.as_tensor(ref.scan_bank(self.config["fs"],
                                             ROBUST.oversample),
                               device=self.device)
        nums = {"verdict_mismatch": 0, "untrue_accept": 0, "wrong": 0,
                "rejected_pct": 0.0, "scan_score_err": 0.0,
                "scan_factor_mismatch": 0, "resample_rel_err": 0.0,
                "host_rows": 0, "sync_val_err": 0.0, "chips_rel_err": 0.0,
                "decode_mismatch": 0, "soft_llr_err": 0.0,
                "soft_ctr_mismatch": 0, "scl_mismatch": 0}
        wants = {b: self._reference(b, cap, tab, bank, st, nums)
                 for b, cap in self.captures.items()}
        rejected = attempted = 0
        for b, verdicts, accepts in records:
            want = wants[b]
            rejected += int((~verdicts).sum())
            attempted += len(verdicts)
            if want is None:
                nums["verdict_mismatch"] += len(verdicts)
                nums["wrong"] += len(verdicts)
                continue
            got_ok = set(np.flatnonzero(verdicts).tolist())
            differ = (got_ok ^ set(want)) | {i for i in got_ok & set(want)
                                             if accepts.get(i) != want[i]}
            untrue = self._untrue(accepts, self.batches[b].starts)
            nums["verdict_mismatch"] += len(differ)
            nums["untrue_accept"] += len(untrue)
            nums["wrong"] += len(differ | untrue)
        nums["rejected_pct"] = 100.0 * rejected / max(attempted, 1)
        return nums

    def _untrue(self, accepts: dict, starts: np.ndarray) -> set:
        """Accepts whose nonce is not the session's, or whose frame does
        not start inside the clip's span of the original stream."""
        span, s = self.stream.span, self.speed
        bad = set()
        for i, (nonce, ctr, _, _) in accepts.items():
            pos = ctr * span - float(starts[i]) * s
            if nonce != self.stream.nonce or not (
                    -span / 2 <= pos <= self.T * s - span / 2):
                bad.add(i)
        return bad

    def _stage_numbers(self, rows, nv, out, tab, peaks, nums) -> dict:
        """``check.py``'s stage numbers of one device stage into ``nums``;
        returns the reference's decode of the program's chips."""
        nv = torch.as_tensor(nv, device=self.device)
        r = ref.stage(rows, nv, out, tab, peaks)
        nums["sync_val_err"] = max(nums["sync_val_err"],
                                   check.sync_err(out["peak_val"],
                                                  r["peak_val"]))
        nums["chips_rel_err"] = max(nums["chips_rel_err"],
                                    check.chips_err(out["chips"],
                                                    r["chips"])[0])
        dec = r["dec"]
        nums["decode_mismatch"] += check.decode_diff(out, dec)
        llr_err, ctr_bad = check.soft_diff(out["scl_llr"], out["scl_ctr"],
                                           dec)
        nums["soft_llr_err"] = max(nums["soft_llr_err"], llr_err)
        nums["soft_ctr_mismatch"] += ctr_bad
        if check.LLR_CONTROL:     # the reference's soft rows in bfloat16
            low = ref_verify.decode(out["chips"], out["peak_idx"],
                                    out["peak_val"], tab,
                                    soft_rows=out["scl_llr"].shape[1],
                                    dtype=torch.bfloat16)
            check.DIAG.setdefault("soft_llr_err_bf16", []).append(
                check.soft_diff(low["scl_llr"], low["scl_ctr"], dec)[0])
            del low
        del dec["llr_rows"], dec["ctr_rows"]
        return dec

    @staticmethod
    def _rungs(ladder: list | None) -> list:
        """A ladder's rungs as ``check.scl_diff`` takes them."""
        return [(n, L, ref_verify.crc_paths(res))
                for n, L, res in ladder or []]

    @torch.no_grad()
    def _reference(self, b: int, cap: dict, tab: dict, bank, st: dict,
                   nums: dict) -> dict | None:
        """The reference's accepts of batch ``b``'s last call, following
        the program; its numbers go into ``nums``.  None (every number at
        its worst) where the call's stages cannot be followed."""
        batch = self.batches[b]
        B = batch.clips.shape[0]
        runs, ladders, rounds = cap["runs"], cap["ladders"], cap["rounds"]
        peaks, list_size = st["peaks"], st["list_size"]
        if len(runs) != 1 + len(rounds) or not ladders or \
                runs[0]["out"]["peak_idx"].shape[0] != B:
            for k, v in nums.items():
                if k not in ("verdict_mismatch", "untrue_accept", "wrong",
                             "rejected_pct"):
                    nums[k] = float("inf") if isinstance(v, float) else v + B
            return None
        first = runs[0]
        dec0 = self._stage_numbers(first["rows"], first["nv"], first["out"],
                                   tab, peaks, nums)
        hard, _ = ref.accepts(dec0, first["out"], tab, list_size, None)
        want = {i: (n, c, s, 1.0) for i, (n, c, s) in hard.items()}

        # the scan, from the clips that the first pass rejected
        real = batch.n_valid.cpu().numpy() > 0
        fail = np.flatnonzero(real & ~np.isin(np.arange(B), list(want)))
        got = (torch.cat([torch.as_tensor(s) for s in cap["scan"]])
               if cap["scan"] else torch.empty(0, bank.shape[0]))
        if got.shape[0] != fail.size:
            nums["scan_score_err"] = float("inf")
            nums["scan_factor_mismatch"] += B
        elif fail.size:
            idx = torch.as_tensor(fail, device=self.device)
            w = ref.scan_scores(batch.clips[idx], batch.n_valid[idx], bank)
            g = got.to(device=w.device, dtype=torch.float64)
            rel = (g - w).abs() / w.abs().clamp(min=1e-30)
            nums["scan_score_err"] = max(nums["scan_score_err"],
                                         check._max_or_zero(rel))
            per_w = w.reshape(fail.size, len(ref.GRID), 4).amax(dim=-1)
            pick = torch.as_tensor(ref.best_factor(g), device=w.device)
            at = per_w.gather(1, pick[:, None])[:, 0]
            best = per_w.amax(dim=-1)
            nums["scan_factor_mismatch"] += int(
                (at < best - self.tie * best.abs()).sum())
            del w, g, rel

        # each retry round at the program's factors, on its own rows
        for k, (run, rnd) in enumerate(zip(runs[1:], rounds)):
            rows, sel, keys = run["rows"], rnd["clips"], rnd["keys"]
            n_dev = len(sel) - rnd["host_rows"]
            nums["host_rows"] += rnd["host_rows"]
            for key in sorted(set(keys[:n_dev])):
                r_idx = [r for r in range(n_dev) if keys[r] == key]
                src = batch.clips[torch.as_tensor([sel[r] for r in r_idx],
                                                  device=self.device)]
                want_rows = ref.resample(src, self.retry_up, key,
                                         rows.shape[1])
                g = rows[torch.as_tensor(r_idx, device=self.device)].to(
                    torch.float64)
                rel = (torch.linalg.vector_norm(g - want_rows, dim=-1)
                       / torch.linalg.vector_norm(want_rows, dim=-1)
                       .clamp(min=1e-30))
                nums["resample_rel_err"] = max(nums["resample_rel_err"],
                                               check._max_or_zero(rel))
                del want_rows, g, src
            dec = self._stage_numbers(rows, run["nv"], run["out"], tab,
                                      peaks, nums)
            acc, rungs = ref.accepts(dec, run["out"], tab, list_size,
                                     np.ones(len(sel), bool))
            got_rungs = self._rungs(ladders[k + 1] if k + 1 < len(ladders)
                                    else None)
            nums["scl_mismatch"] += check.scl_diff(got_rungs, rungs)
            for r, (n, c, s) in sorted(acc.items()):
                want.setdefault(sel[r], (n, c, s, keys[r] / self.retry_up))
            del dec

        # the deferred ladder, on the first pass's outputs
        left = real & ~np.isin(np.arange(B), list(want))
        deferred = ladders[len(runs)] if len(ladders) > len(runs) else None
        if left.any():
            acc, rungs = ref.accepts(dec0, first["out"], tab, list_size, left)
            for i, (n, c, s) in acc.items():
                want.setdefault(i, (n, c, s, 1.0))
        else:
            rungs = []
        nums["scl_mismatch"] += check.scl_diff(self._rungs(deferred), rungs)
        if batch.clips.is_cuda:
            torch.cuda.empty_cache()
        return want


Runner = RecoverCell
