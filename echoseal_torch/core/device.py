"""The port's device rule: ``None`` means the CUDA card, which must exist."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> CUDA, which must exist; anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
