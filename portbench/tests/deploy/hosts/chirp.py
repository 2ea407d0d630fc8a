"""A test deployment's host: a linear chirp from ``hz0`` to ``hz1`` over
the stream, at ``amp``."""
from __future__ import annotations

import numpy as np


def make(spec: dict, n: int, fs: int, rng: np.random.Generator
         ) -> np.ndarray:
    t = np.arange(n) / fs
    rate = (spec["hz1"] - spec["hz0"]) / (n / fs)
    phase = 2 * np.pi * (spec["hz0"] * t + 0.5 * rate * t * t)
    return (spec["amp"] * np.sin(phase)).astype(np.float32)
