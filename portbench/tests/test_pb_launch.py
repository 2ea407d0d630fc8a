"""``run.py`` on a cell of N > 1 cards: N ranks in a ``gloo`` group on the
CPU, stepped by rank 0, one result line, every rank ended; a rank that
raises, dies or hangs ends the run non-zero, with no result, within the
group's timeout.  A cell of one card starts no process and no group."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest

from portbench import harness
from portbench.tests.pb_fixtures import two_threads  # noqa: F401

TIMEOUT_S = 15.0         # the test group's timeout


@pytest.fixture
def ring_root(tmp_path):
    return make_ring(tmp_path)


def make_ring(root):
    """A checkout under ``root`` holding only the ring cells:
    ``ring.<fail>`` on two ranks and ``ring.one`` on one."""
    pb = root / "portbench"
    for d in ("runners", "traffic", "limits", "configs"):
        (pb / d).mkdir(parents=True)
    (pb / "runners" / "allreduce.py").write_bytes(
        (harness.PKG / "tests" / "ring" / "allreduce.py").read_bytes())
    (pb / "configs" / "ring.json").write_text('{"name": "ring"}')
    cells = {"ring.ok": (2, None), "ring.raise": (2, "raise"),
             "ring.exit": (2, "exit"), "ring.hang": (2, "hang"),
             "ring.one": (1, None)}
    work = []
    for name, (chips, fail) in cells.items():
        traffic = name.split(".")[1]
        (pb / "traffic" / f"{traffic}.json").write_text(json.dumps(
            {"entry": "allreduce", "fail": fail}))
        (pb / "limits" / f"{name}.json").write_text('{"sum_mismatch": 0}')
        work.append({"name": name, "config": "ring", "traffic": traffic,
                     "chips": chips, "why": "a test cell"})
    spec = {"configs": [{"name": "ring", "file": "portbench/configs/ring.json"}],
            "workloads": work,
            "end_to_end": [
                {"name": "audio_s_per_s", "unit": "audio-s/s",
                 "better": "higher", "bound": 0.1, "source": "host_clock"},
                {"name": "setup_s", "unit": "s", "better": "lower",
                 "bound": 0.25, "source": "host_clock"}],
            "per_layer": []}
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run_py(root, cell: str, prelude: str = ""
           ) -> tuple[subprocess.CompletedProcess, float]:
    """``run.py`` on the CPU in a fresh process (``prelude`` first), as
    the command line runs it but for the device; with its wall seconds.
    The launching process itself never joins a group."""
    code = f"""{prelude}
import sys
from pathlib import Path
import torch.distributed as dist
sys.path.insert(0, {str(harness.ROOT)!r})
from portbench import run
rc = run.main(sys.argv[1:], device="cpu", root=Path({str(root)!r}),
              group_timeout_s={TIMEOUT_S})
assert not dist.is_initialized()
sys.exit(rc)
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t = time.monotonic()
    p = subprocess.run([sys.executable, "-c", code, "--workload", cell,
                        "--seed", str(2 ** 31 + 99), "--seconds", "0.5",
                        "--trace", "0"], capture_output=True, text=True,
                       env=env, timeout=240)
    return p, time.monotonic() - t


def pids_ended(root) -> list[int]:
    pids = [int(p.name) for p in (root / "pids").iterdir()]
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    return pids


def test_two_ranks_one_result(ring_root):
    p, _ = run_py(ring_root, "ring.ok")
    assert p.returncode == 0, p.stderr[-4000:]
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1 and p.stdout.splitlines()[-1] == lines[0]
    out = json.loads(lines[0])
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 4
    assert out["device"]["count"] == 2
    assert out["metrics"]["setup_s"]["value"] > 0
    assert p.stderr.splitlines()[-1] == "check sum_mismatch = 0 (limit 0)"
    assert len(pids_ended(ring_root)) == 2


@pytest.mark.parametrize("fail", ["raise", "exit", "hang"])
def test_failing_rank_ends_the_run(ring_root, fail):
    p, wall = run_py(ring_root, f"ring.{fail}")
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert wall < TIMEOUT_S + 60
    assert len(pids_ended(ring_root)) == 2


REFUSE = """
import torch.multiprocessing as mp

def refused(*a, **k):
    raise AssertionError("a one-card cell started a process or group")

mp.start_processes = mp.spawn = refused
import torch.distributed
torch.distributed.init_process_group = refused
"""


def test_one_card_starts_no_process_and_no_group(ring_root):
    p, _ = run_py(ring_root, "ring.one", REFUSE)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.splitlines()[-1])
    assert out["correct"] and out["device"]["count"] == 0
    assert len(pids_ended(ring_root)) == 1      # run.py's own process
