"""A sine host: ``{"kind": "tone", "hz": ..., "amp": ...}``."""
from __future__ import annotations

import numpy as np


def make(spec: dict, n: int, fs: int, rng: np.random.Generator
         ) -> np.ndarray:
    t = np.arange(n) / fs
    return (spec["amp"] * np.sin(2 * np.pi * spec["hz"] * t)
            ).astype(np.float32)
