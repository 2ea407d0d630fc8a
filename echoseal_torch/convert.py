"""Carry a verifier's state -- its key and design tables -- into torch.

The compat verifier's "weights" are seven tables: the sync templates, the
exact-inversion demod matrices ``m_direct``, the forward models ``t_fwd``,
the preamble and header PN symbols, and the per-key PN and hop tables.
``tables_from_numpy`` takes them as numpy arrays -- from
``pipeline.host_tables`` or from any other verifier, e.g.
``np.asarray(bv._m_direct)`` of ``echoseal_tpu``'s ``BatchVerifier`` -- and
returns them as tensors of the port's dtypes on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

TABLE_DTYPES = {
    "templates": torch.float32,   # (4, 63)
    "m_direct": torch.float32,    # (4, 1215, 1215)
    "t_fwd": torch.float32,       # (4, 1215, 1215)
    "pre_sy": torch.float32,      # (63,)
    "hdr_pn_sy": torch.float32,   # (128,)
    "pn_table": torch.int8,       # (max_ctr, 1024) payload PN bits
    "hop_table": torch.int32,     # (max_ctr,) band index per counter
}


def tables_from_numpy(d: dict[str, np.ndarray],
                      device: str | torch.device) -> dict[str, torch.Tensor]:
    """Numpy tables -> tensors (copies) on ``device``; keys are checked."""
    if set(d) != set(TABLE_DTYPES):
        raise KeyError(f"tables need keys {sorted(TABLE_DTYPES)}, "
                       f"got {sorted(d)}")
    return {k: torch.as_tensor(np.array(d[k]), dtype=dt, device=device)
            for k, dt in TABLE_DTYPES.items()}
