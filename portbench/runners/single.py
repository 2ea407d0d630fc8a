"""Single-clip requests in a closed loop, one client, through one
detector; the comparison is ``check.compare_single``."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check, gen
from portbench.harness import build_system, reference_tables, settings
from portbench.ref import verify as ref
from portbench.ref.bandplan import BAND_PLAN

_CAP: dict = {}


class SingleCell:
    """A closed loop of single-clip requests, one client: each request one
    cut of the pool, as numpy host audio, through one detector built in
    set-up (the way a stream monitor holds one)."""

    entry = "single"

    def __init__(self, cell: dict, seed: int, device, verifier=None) -> None:
        from echoseal_torch.models import detector

        self.config, self.traffic = cell["config"], cell["traffic"]
        self.device = device
        t0 = time.perf_counter()
        self.verifier = verifier or build_system(self.config, "single",
                                                 device)
        t1 = time.perf_counter()
        self.stream, self.cuts, self.order = gen.make_cuts(
            self.config, self.traffic, seed, cell["root"])
        self.setup_parts = {"verifier_s": t1 - t0,
                            "inputs_s": time.perf_counter() - t1}
        self.T = int(round(self.traffic["clip_s"] * self.config["fs"]))
        self.fs = self.config["fs"]
        self.captures: dict[int, dict] = {}
        self.batches = self.cuts          # the unit a traced run covers once
        if not hasattr(detector._scan_stage, "_portbench"):
            scan = detector._scan_stage

            def _scan_stage(*a, **k):
                _CAP["out"] = scan(*a, **k)
                return _CAP["out"]

            _scan_stage._portbench = True
            detector._scan_stage = _scan_stage

    def call(self, i: int):
        c = int(self.order[i % self.order.size])
        _CAP.clear()
        with torch.profiler.record_function("portbench.verify_detailed"):
            res = self.verifier.verify_detailed(self.cuts[c].audio, self.fs)
        if "out" in _CAP:
            o = _CAP["out"]
            self.captures[c] = {k: o[k] for k in ("peak_idx", "peak_val",
                                                  "chips_d")}
        accepts = {}
        if res.authentic:
            band = [tuple(b) for b in BAND_PLAN].index(tuple(res.band))
            accepts[0] = (res.session_nonce, int(res.frame_ctr), res.stage,
                          int(res.peak_pos), band)
        return c, np.array([bool(res.authentic)]), accepts

    def warm_up(self) -> None:
        """One pass over the pool: every shape and path the requests use."""
        for i in range(len(self.cuts)):
            self.call(i)

    def work(self, c: int) -> float:
        return self.T / self.fs

    def check(self, records: list) -> dict:
        cfg = self.config
        tab = reference_tables(cfg, "single", self.device)
        return check.compare_single(tab, self.cuts, self.stream, records,
                                    self.captures,
                                    settings(cfg, "single")["peaks"], self.T)

    def free_program(self) -> None:
        self.verifier.tables = None

    def sync_rows(self):
        """Each cut zero-padded as the scan pads it, with its length."""
        for cut in self.cuts:
            x = torch.zeros(1, ref.pad_bucket(max(self.T, 2 * 1215 + 512)),
                            device=self.device)
            x[0, :self.T] = torch.as_tensor(cut.audio, device=self.device)
            yield x, torch.tensor([self.T], device=self.device)


Runner = SingleCell
