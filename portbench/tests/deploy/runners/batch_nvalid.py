"""A test deployment's runner: the batch runner, and the clip lengths it
handed the program read back after the window (``n_valid_mismatch``)."""
from __future__ import annotations

from portbench import harness

Batch = harness.runner_class("batch")


class Runner(Batch):
    entry = "batch_nvalid"

    def check(self, records: list) -> dict:
        nums = super().check(records)
        nums["n_valid_mismatch"] = sum(int((b.n_valid != self.T).sum())
                                       for b in self.batches)
        return nums
