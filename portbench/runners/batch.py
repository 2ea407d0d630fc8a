"""``verify_batch`` in a closed loop, one client, over the traffic's
distinct batches in turn; the comparison is ``check.compare``."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check, gen
from portbench.harness import build_system, reference_tables, settings
from portbench.ref import verify as ref

_CAP: dict = {}


def _hook(verifier) -> None:
    """Keep each call's stage outputs and ladder rungs in ``_CAP`` for the
    check: the verifier's ``run_device`` and the ladder's
    ``pipeline.scl_decode_serving``, each wrapped once."""
    from echoseal_torch.models import pipeline

    if not hasattr(verifier, "_portbench_run"):
        run = verifier._portbench_run = verifier.run_device

        def run_device(*a, **k):
            _CAP["out"] = run(*a, **k)
            return _CAP["out"]

        verifier.run_device = run_device
    if not hasattr(pipeline.scl_decode_serving, "_portbench"):
        decode = pipeline.scl_decode_serving

        def scl_decode_serving(llr, spec, list_size):
            res = decode(llr, spec, list_size)
            _CAP.setdefault("rungs", []).append(
                (llr.shape[0], list_size, res))
            return res

        scl_decode_serving._portbench = True
        pipeline.scl_decode_serving = scl_decode_serving


class BatchCell:
    """A closed loop of ``verify_batch`` calls, one client, over the
    traffic's distinct batches in turn."""

    entry = "batch"

    def __init__(self, cell: dict, seed: int, device, verifier=None) -> None:
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.device = device
        t0 = time.perf_counter()
        self.verifier = verifier or build_system(self.config, "batch", device)
        t1 = time.perf_counter()
        self.stream, self.batches = gen.make_batches(
            self.config, self.traffic, seed, device, cell["root"])
        self.setup_parts = {"verifier_s": t1 - t0,
                            "inputs_s": time.perf_counter() - t1}
        self.T = int(round(self.traffic["clip_s"] * self.config["fs"]))
        self.captures: dict[int, dict] = {}
        _hook(self.verifier)

    def call(self, i: int):
        """One request: batch ``i % batches``; returns (batch, verdicts,
        accepts) and keeps the call's stage outputs as that batch's."""
        b = i % len(self.batches)
        batch = self.batches[b]
        _CAP.clear()
        if hasattr(self.verifier, "scl_rungs"):
            self.verifier.scl_rungs = []
        details: dict = {}
        with torch.profiler.record_function("portbench.verify_batch"):
            verdicts = self.verifier.verify_batch(batch.clips, batch.n_valid,
                                                  details=details)
        self.captures[b] = dict(_CAP)
        accepts = {i: (d.session_nonce, int(d.frame_ctr), d.stage)
                   for i, d in details.items()}
        return b, np.asarray(verdicts, bool), accepts

    def warm_up(self) -> None:
        for i in range(len(self.batches)):
            self.call(i)

    def work(self, b: int) -> float:
        return self.batches[b].seconds

    def check(self, records: list) -> dict:
        """Every comparison number of the cell (after the window)."""
        wave = self.config["waveform"]
        tab = reference_tables(self.config, "batch", self.device)
        caps = {}
        for b, c in self.captures.items():
            rungs = [(n, L, ref.crc_paths(res)) for n, L, res
                     in c.get("rungs", [])]
            caps[b] = dict(out=c["out"], rungs=rungs)
        st = settings(self.config, "batch")
        return check.compare(wave, tab, self.batches, self.stream, records,
                             caps, st.get("list_size"), st["peaks"], self.T)

    def free_program(self) -> None:
        """Drop the program's tables; the captured outputs stay."""
        self.verifier.tables = None

    def sync_rows(self):
        for b in self.batches:
            yield b.clips, b.n_valid


Runner = BatchCell
