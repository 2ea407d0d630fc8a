"""Run one cell of the port's benchmark once, on the card(s) of this host.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks``: each compared number beside its limit), and the same checks
as the last lines of standard error.  Without CUDA cards enough for the
cell it prints no result and exits 2.  A cell of one card runs in this
process; a cell of N > 1 cards in N processes, one a card (``launch``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench-cache"


def _caches() -> None:
    """Every kernel and build cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None, *, device: str | None = None, root: Path = ROOT,
         group_timeout_s: float | None = None) -> int:
    """The command line's run.  ``device="cpu"`` (the tests' only way in)
    runs on the CPU: ranks of a multi-card cell in a ``gloo`` group whose
    timeout is ``group_timeout_s``; ``root`` holds the ``BENCHMARK.json``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[0] = str(ROOT)      # not portbench/: its trace.py is no stdlib
    import torch

    from portbench import harness

    need = harness.load_cell(args.workload, root)["cell"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device is None and have < need:
        print(f"portbench: needs {need} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    if need == 1:
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START, device=device,
                          root=root)
    else:
        from portbench import launch

        out = launch.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), chips=need, t_start=T_START,
                         device_type=device or "cuda", root=root,
                         timeout_s=group_timeout_s or launch.GROUP_TIMEOUT_S)
        if isinstance(out, int):
            return out
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
