"""Files found by name: ``portbench/<folder>/<name>.py`` under a
checkout's root (runners, hosts, channels, per-layer metrics).

A file is loaded once a process: where a module of the same folder and
name was loaded from a file with the same bytes (this checkout's own, or
a copy of it under another root), that module is the one returned.  The
runners keep hooks on the program that are installed once a process, with
one capture dict, so two copies of one runner must not both run.
"""
from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path
from types import ModuleType


def load(folder: str, name: str, root: Path) -> ModuleType:
    """The module of ``root/portbench/<folder>/<name>.py``."""
    path = Path(root) / "portbench" / folder / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {folder} file named {name!r}: {path}")
    source = path.read_bytes()
    key = "portbench_" + re.sub(r"\W", "_", f"{folder}_{name}")
    mod = sys.modules.get(key)
    if mod is not None and mod.__portbench_source__ == source:
        return mod
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    mod.__portbench_source__ = source
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod
