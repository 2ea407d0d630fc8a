"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W), and
the operation and byte counts of the kernels that have a roofline metric."""
from __future__ import annotations

FP32_FLOPS = 67e12          # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def ls_demod_work(B: int, K: int, span: int, profiles: int = 2,
                  chips: int = 1215) -> tuple[float, float]:
    """(float32 operations, bytes) of the v2 LS demod GEMM
    (4, B*K, span) @ (4, span, profiles*chips): each input byte read once,
    each output byte written once."""
    rows, cols = B * K, profiles * chips
    flops = 2.0 * 4 * rows * span * cols
    nbytes = 4.0 * 4 * (rows * span + span * cols + rows * cols)
    return flops, nbytes


def roofline_pct(flops: float, nbytes: float, seconds: float) -> float:
    """The least time the chip could take over the time taken, in %."""
    return 100.0 * max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S) / seconds
