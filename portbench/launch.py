"""One run of a cell on N > 1 cards: N processes, one a card, in one
process group (``nccl`` on cards, ``gloo`` on the CPU for the tests).

Rank 0 runs ``harness.run`` as one process runs a one-card cell: set-up,
warm-up, window, traced run and check, all read on rank 0.  Before each
of its runner's calls it broadcasts the call's index, and every other
rank makes the same call on its own runner; -1 ends them.  Then the
ranks take the largest peak of device memory, and rank 0 hands its
result to the launching process, which prints it once every rank has
ended cleanly.  A rank that raises or dies ends the others, and the run
exits non-zero with no result; a rank that waits on a collective no
other rank makes fails after the group's timeout (``nccl`` then takes
about 70 s more to end the process).
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import socket
import sys
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from portbench import harness

# the longest wait on another rank: rank 0's check after the window (v2
# MP3: ~10 s) or a first run's kernel builds inside a call (~40 s)
GROUP_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in the group, handed to its runner."""

    rank: int
    world: int
    device: torch.device


def lead(runner, ranks: Ranks) -> None:
    """Rank 0: broadcast each call's index before the call itself (every
    caller of ``runner.call``, the runner's own ``warm_up`` too)."""
    call = runner.call

    def stepped(i: int):
        dist.broadcast(torch.tensor([i], device=ranks.device), 0)
        return call(i)

    runner.call = stepped


def follow(runner, ranks: Ranks) -> None:
    """Any other rank: the calls rank 0 broadcasts, until -1."""
    step = torch.empty(1, dtype=torch.int64, device=ranks.device)
    while True:
        dist.broadcast(step, 0)
        i = int(step.item())
        if i < 0:
            return
        runner.call(i)


def _rank(rank: int, world: int, port: int, device_type: str, job: dict,
          timeout_s: float, results) -> None:
    """One rank of the run, from its spawn to the group's end."""
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        kw = {"backend": "nccl", "device_id": device}
    else:
        device, kw = torch.device("cpu"), {"backend": "gloo"}
    dist.init_process_group(
        init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    try:
        out = _steps(Ranks(rank, world, device), job)
    except Exception:
        # end at once: leaving a broken group can wait on the other ranks
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: rank {rank} loaded {', '.join(bad)}",
              file=sys.stderr, flush=True)
        os._exit(3)
    peak = torch.tensor([out["device"]["memory_peak_bytes"]],
                        dtype=torch.int64, device=device)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    if rank == 0:
        out["device"].update(count=world, memory_peak_bytes=int(peak.item()))
        results.put(json.dumps(out))
    dist.destroy_process_group()


def _steps(ranks: Ranks, job: dict) -> dict:
    """Rank 0: the run's result; any other rank: its calls, and its
    device's peak memory in the result's form."""
    if ranks.rank == 0:
        out = harness.run(job["name"], job["seed"], job["seconds"],
                          job["traced"], t_start=job["t_start"],
                          device=ranks.device, root=job["root"], ranks=ranks)
        dist.broadcast(torch.tensor([-1], device=ranks.device), 0)
        return out
    _, runner = harness.build(job["name"], job["seed"], ranks.device,
                              root=job["root"], ranks=ranks)
    follow(runner, ranks)
    cuda = ranks.device.type == "cuda"
    return {"device": {"memory_peak_bytes": int(
        torch.cuda.max_memory_allocated(ranks.device)) if cuda else 0}}


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(name: str, seed: int, seconds: float, traced: bool, *, chips: int,
        t_start: float, device_type: str = "cuda", root: Path = harness.ROOT,
        timeout_s: float = GROUP_TIMEOUT_S) -> dict | int:
    """The result line's object of a run on ``chips`` ranks, or the exit
    code of a run that failed (its cause printed on standard error).
    ``t_start`` is the launching process's start: set-up counts the
    ranks' spawn and the group's start too."""
    results = mp.get_context("spawn").SimpleQueue()
    job = dict(name=name, seed=seed, seconds=seconds, traced=traced,
               t_start=t_start, root=root)
    ctx = mp.start_processes(
        _rank, args=(chips, _free_port(), device_type, job, timeout_s,
                     results),
        nprocs=chips, join=False, start_method="spawn")
    line = None
    try:
        while not ctx.join(timeout=1.0):
            if line is None and not results.empty():
                line = results.get()
    except mp.ProcessExitedException as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.exit_code if e.exit_code > 0 else 1
    except mp.ProcessRaisedException as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    if line is None and not results.empty():
        line = results.get()
    if line is None:
        print("portbench: rank 0 ended with no result", file=sys.stderr)
        return 1
    return json.loads(line)
