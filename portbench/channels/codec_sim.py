"""The frozen MP3-like codec simulation at a bitrate:
``{"kind": "codec_sim", "bitrate_kbps": ...}``; the rate stays."""
from __future__ import annotations

import numpy as np

from portbench.ref.channels import codec_sim


def apply(x: np.ndarray, spec: dict, fs: int, rng: np.random.Generator
          ) -> tuple[np.ndarray, int]:
    return codec_sim(x, spec["bitrate_kbps"], fs), fs
