"""echoseal_torch: the EchoSeal receiver and transmitter in PyTorch + CUDA.

The PyTorch / NVIDIA H100 port of ``echoseal_tpu``, kept beside it as a
package of its own: it imports torch, numpy, scipy and the standard
library, never JAX, ``echoseal_tpu`` or ``cryptography``.  The JAX package
stays the reference each ported function is checked against.

Public surface (so far: the whole batch tier and the host TX):

    BatchVerifier        -- compat multi-clip verification, one device stage
    RobustBatchVerifier  -- v2 multi-clip verification with the SCL ladder,
                            ``fs_in`` ingest and time-scale recovery
    BatchEmbedder        -- bulk compat TX, frames synthesised on the device
    WatermarkEmbedder    -- streaming compat TX mixer (sample-exact format)
    RobustEmbedder       -- streaming v2 TX mixer
    SecureChannel        -- HKDF/AEAD/PN crypto core (host-side)
    TxParams             -- TX configuration dataclass
"""
from echoseal_torch.core.crypto import SecureChannel
from echoseal_torch.core.params import TxParams
from echoseal_torch.models.embedder import BatchEmbedder, WatermarkEmbedder
from echoseal_torch.models.pipeline import BatchVerifier, RobustBatchVerifier
from echoseal_torch.models.robust import RobustEmbedder

__all__ = ["BatchVerifier", "RobustBatchVerifier", "BatchEmbedder",
           "WatermarkEmbedder", "RobustEmbedder", "SecureChannel", "TxParams"]
