"""A test runner for a cell of N cards: each call one ``all_reduce`` of
``rank + i`` over the group, answered right where the sum is.  The
traffic's ``fail`` makes the last rank fail at its fifth call (the
window's third):
``raise``, ``exit`` (the process dies) or ``hang`` (it waits forever,
outside any collective).  Each rank notes its process id under
``<root>/pids``."""
from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist


class Runner:
    entry = "allreduce"

    def __init__(self, cell: dict, seed: int, device, verifier=None) -> None:
        self.ranks, self.device = cell["ranks"], device
        self.rank = 0 if self.ranks is None else self.ranks.rank
        self.world = 1 if self.ranks is None else self.ranks.world
        self.fail = cell["traffic"].get("fail")
        self.verifier = None
        self.batches = [0, 1]
        self.setup_parts: dict = {}
        self.calls = 0
        pids = cell["root"] / "pids"
        pids.mkdir(exist_ok=True)
        (pids / str(os.getpid())).write_text(str(self.rank))

    def call(self, i: int):
        self.calls += 1
        if self.fail and self.calls == 5 and self.rank == self.world - 1:
            if self.fail == "raise":
                raise RuntimeError("a rank fails")
            if self.fail == "exit":
                os._exit(9)
            time.sleep(3600)
        x = torch.tensor([float(self.rank + i)], device=self.device)
        if self.ranks is not None:
            dist.all_reduce(x)
        want = sum(r + i for r in range(self.world))
        return i % 2, np.array([float(x.item()) == want]), {}

    def warm_up(self) -> None:
        for i in range(len(self.batches)):
            self.call(i)

    def work(self, b: int) -> float:
        return 1.0

    def check(self, records: list) -> dict:
        bad = sum(int((~r[1]).sum()) for r in records)
        return {"sum_mismatch": bad, "wrong": bad}

    def free_program(self) -> None:
        pass

    def sync_rows(self):
        return iter(())
