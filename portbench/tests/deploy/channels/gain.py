"""A test deployment's channel: a gain of ``db`` decibels; the rate stays."""
from __future__ import annotations

import numpy as np


def apply(x: np.ndarray, spec: dict, fs: int, rng: np.random.Generator
          ) -> tuple[np.ndarray, int]:
    return x * np.float32(10.0 ** (spec["db"] / 20)), fs
