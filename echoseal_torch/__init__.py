"""echoseal_torch: the EchoSeal receiver and transmitter in PyTorch + CUDA.

The PyTorch / NVIDIA H100 port of ``echoseal_tpu``, kept beside it as a
package of its own: it imports torch, numpy, scipy and the standard
library, never JAX, ``echoseal_tpu`` or ``cryptography``.  The JAX package
stays the reference each ported function is checked against.

Public surface (this slice: the compat batch verify and the host TX):

    BatchVerifier      -- multi-clip verification, one device stage per batch
    WatermarkEmbedder  -- streaming TX mixer (sample-exact wire format)
    SecureChannel      -- HKDF/AEAD/PN crypto core (host-side)
    TxParams           -- TX configuration dataclass
"""
from echoseal_torch.core.crypto import SecureChannel
from echoseal_torch.core.params import TxParams
from echoseal_torch.models.embedder import WatermarkEmbedder
from echoseal_torch.models.pipeline import BatchVerifier

__all__ = ["BatchVerifier", "WatermarkEmbedder", "SecureChannel", "TxParams"]
