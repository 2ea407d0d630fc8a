"""Carry a verifier's state -- its key and design tables -- into torch.

A verifier's "weights" are its tables.  The compat verifier has seven:
the sync templates, the exact-inversion demod matrices ``m_direct``, the
forward models ``t_fwd``, the preamble and header PN symbols, and the
per-key PN and hop tables.  The v2 (robust) verifier has six: the
oversampled sync templates, the LS demod stack ``m_stack`` (both lam
profiles), the preamble and header PN symbols, and the same PN and hop
tables.

The single-clip verifiers keep design tables only (their PN is generated
per candidate on the host): ``WatermarkDetector`` has seven
(``DETECTOR_TABLE_DTYPES``), ``RobustVerifier`` four
(``VERIFIER_TABLE_DTYPES``).

``tables_from_numpy`` takes them as numpy arrays -- from the port's
``pipeline.host_tables`` / ``host_tables_v2`` or from another verifier --
and returns them as tensors of the port's dtypes on ``device``.
``numpy_tables_of`` reads them off any verifier that keeps each table as an
attribute ``_<name>``, as ``echoseal_tpu``'s four verifiers do, so that
both packages can run on identical tables (each port class has a
``from_tables`` constructor).
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

V2_TABLE_DTYPES = {
    "templates": torch.float32,   # (4, 63 * S): (4, 504) at S = 8
    "m_stack": torch.float32,     # (4, 2, 1215, 1215 * S): 378 MB at S = 8
    "pre_sy": torch.float32,      # (63,)
    "hdr_pn_sy": torch.float32,   # (128,)
    "pn_table": torch.int8,       # (max_ctr, 1024) payload PN bits
    "hop_table": torch.int32,     # (max_ctr,) band index per counter
}

DETECTOR_TABLE_DTYPES = {
    "templates": torch.float32,   # (4, 63)
    "m_direct": torch.float32,    # (4, 2, 1215, 1215): refined | raw profile
    "m_cascade": torch.float32,   # (4, 1, 1215, 1727) TX*RX cascade model
    "t_fwd": torch.float32,       # (4, 1215, 1215)
    "fir_bank": torch.float32,    # (4, Lf) RX band FIRs, zero-padded rows
    "pre_sy": torch.float32,      # (63,)
    "hdr_pn_sy": torch.float32,   # (128,)
}

VERIFIER_TABLE_DTYPES = {
    "templates": torch.float32,   # (4, 63 * S)
    "m_stack": torch.float32,     # (4, 2, 1215, 1215 * S): 378 MB at S = 8
    "pre_sy": torch.float32,      # (63,)
    "hdr_pn_sy": torch.float32,   # (128,)
}

# built on the first time-scale recovery, outside the verifier's ``tables``
SCAN_TABLE_DTYPES = {
    "scan_bank": torch.float32,   # (31 * 4, ~531) scaled sync templates
    "scan_spectra": torch.complex64,   # (31 * 4, 2049) their rfft at 4096
}


def tables_from_numpy(d: dict[str, np.ndarray], device: str | torch.device,
                      dtypes: dict[str, torch.dtype] = TABLE_DTYPES
                      ) -> dict[str, torch.Tensor]:
    """Numpy tables -> tensors (copies) on ``device``; keys are checked."""
    if set(d) != set(dtypes):
        raise KeyError(f"tables need keys {sorted(dtypes)}, got {sorted(d)}")
    return {k: torch.as_tensor(np.array(d[k]), dtype=dt, device=device)
            for k, dt in dtypes.items()}


def numpy_tables_of(verifier, dtypes: dict[str, torch.dtype] = TABLE_DTYPES
                    ) -> dict[str, np.ndarray]:
    """The tables a verifier keeps as ``_<name>`` attributes, as numpy."""
    return {k: np.asarray(getattr(verifier, "_" + k)) for k in dtypes}
