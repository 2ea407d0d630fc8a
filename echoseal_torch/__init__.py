"""echoseal_torch: the EchoSeal receiver and transmitter in PyTorch + CUDA.

The PyTorch / NVIDIA H100 port of ``echoseal_tpu``, kept beside it as a
package of its own: it imports torch, numpy, scipy and the standard
library, never JAX, ``echoseal_tpu`` or ``cryptography``.  The JAX package
stays the reference each ported function is checked against.

Public surface (the batch tier, the single-clip tier, the stream
monitors, the verifier pool and the TX; the CLIs are
``echoseal_torch.cli.rx_app`` / ``tx_app``):

    WatermarkDetector    -- compat single-clip verification, full ladder
    RobustVerifier       -- v2 single-clip verification with the
                            time-scale recovery ladder
    BatchVerifier        -- compat multi-clip verification, one device stage
    RobustBatchVerifier  -- v2 multi-clip verification with the SCL ladder,
                            ``fs_in`` ingest and time-scale recovery
    StreamMonitor        -- sliding-window verdicts over an arriving stream
    BatchStreamMonitor   -- the same with windows as batch-tier rows
    VerifierPool         -- LRU cache of per-key batch verifiers
    BatchEmbedder        -- bulk compat TX, frames synthesised on the device
    WatermarkEmbedder    -- streaming compat TX mixer (sample-exact format)
    RobustEmbedder       -- streaming v2 TX mixer
    SecureChannel        -- HKDF/AEAD/PN crypto core (host-side)
    TxParams / RxParams  -- TX / RX configuration dataclasses
    VerifyResult         -- the single-clip verdict record
"""
from echoseal_torch.core.crypto import SecureChannel
from echoseal_torch.core.params import RxParams, TxParams
from echoseal_torch.models.detector import VerifyResult, WatermarkDetector
from echoseal_torch.models.embedder import BatchEmbedder, WatermarkEmbedder
from echoseal_torch.models.monitor import (
    BatchStreamMonitor,
    MonitorEvent,
    StreamMonitor,
)
from echoseal_torch.models.pipeline import BatchVerifier, RobustBatchVerifier
from echoseal_torch.models.robust import RobustEmbedder, RobustVerifier
from echoseal_torch.models.service import VerifierPool

__all__ = ["WatermarkDetector", "RobustVerifier", "BatchVerifier",
           "RobustBatchVerifier", "StreamMonitor", "BatchStreamMonitor",
           "MonitorEvent", "VerifierPool", "VerifyResult", "BatchEmbedder",
           "WatermarkEmbedder", "RobustEmbedder", "SecureChannel", "TxParams",
           "RxParams"]
