"""What the benchmark may import: nothing of JAX or the JAX package
anywhere under ``portbench/``, and nothing of the program in the plain
reference; nothing reads the JAX package's benchmark files."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest
from portbench.tests.pb_fixtures import two_threads  # noqa: F401

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "echoseal_tpu"}
FILES = sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)
RUN_FILES = [p for p in FILES if "tests" not in p.relative_to(PB).parts]


def imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "ref").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & {"echoseal_torch", "portbench"}


def test_whole_name_comparison():
    """``echoseal_torch`` starts with the JAX package's name and is allowed."""
    assert "echoseal_torch".split(".")[0] not in FORBIDDEN
    assert "echoseal_tpu.ops".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", RUN_FILES,
                         ids=lambda p: str(p.relative_to(PB)))
def test_reads_no_jax_benchmark_file(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "bench.py" not in node.value.replace("portbench", "")
            assert "benchmarks/" not in node.value
