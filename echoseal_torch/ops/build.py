"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``echoseal_torch/csrc/<name>.cu`` exposes a plain C launcher and is
compiled on its own into ``build/echoseal_torch/lib<name>-<hash>.so`` at
the repository root, where ``<hash>`` is the source's SHA-256 prefix: a
changed source builds anew, an unchanged one loads the existing library.
Nothing here runs at import time; a build or load failure raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from functools import lru_cache
from pathlib import Path

# kernel name -> launches so far; each wrapper adds one per launch, and a
# caller clears it to count the launches of one run
LAUNCHES: Counter[str] = Counter()

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "echoseal_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return str(path)


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet.

    One nvcc process per source, all started together; the library is
    written to a temporary name and renamed into place, so a concurrent
    or interrupted build never leaves a partial library under the final
    name.  Raises with nvcc's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in (names or sources())}
    procs = {}
    for name, lib in out.items():
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out[name])
        else:
            os.unlink(tmp)
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it if needed)."""
    return ctypes.CDLL(str(build([name])[name]))
