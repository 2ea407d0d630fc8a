"""Fixtures of the benchmark's own tests (imported by each test module):
two torch threads a test (they share the host with others), the card, and
a checkout whose ``BENCHMARK.json`` holds the single-clip cell again.

Run them from the repository root: ``python3 -m pytest portbench/tests``
(on the card, the ``cuda``-marked control runs too)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness

SINGLE = "compat.single-clip"


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA card, decided when a test asks for it; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def with_single_clip(dst: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and the benchmark's data under ``dst``
    with the entries of ``single_clip_cell.json`` added: the single-clip
    cell, its end-to-end metrics and its per-layer metrics, as a later
    ``benchmark`` change would add them back."""
    shutil.copytree(harness.PKG, dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    add = json.loads((Path(__file__).parent / "single_clip_cell.json")
                     .read_text())
    for key in ("workloads", "end_to_end", "per_layer"):
        spec[key] += add[key]
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return dst


@pytest.fixture(scope="module")
def single_root(tmp_path_factory):
    return with_single_clip(tmp_path_factory.mktemp("single-clip"))
