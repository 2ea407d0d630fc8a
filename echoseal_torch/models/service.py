"""Multi-tenant verification service tier: per-key verifier pooling.

A serving deployment verifies clips for MANY keys (tenants).  Each
batched verifier holds sizeable per-key device state (PN/hop counter
tables; the v2 profile adds ~380 MB of LS demod matrices shared across
keys via lru_cache), so verifiers must be reused across requests and
bounded in number.  ``VerifierPool`` is that cache:

    pool = VerifierPool(profile="v2", max_keys=8)
    verdicts = pool.verify(tenant_key, clips, n_valid)

* LRU eviction: the least-recently-used key's verifier (and its device
  tables) is dropped when ``max_keys`` is exceeded -- device buffers are
  freed by GC once unreferenced.
* Thread-safe around the cache structure (verifier construction happens
  outside the lock; a duplicate build for the same key is harmless and
  the second one wins).
* Profile-agnostic: "compat" pools ``BatchVerifier``, "v2" pools
  ``RobustBatchVerifier`` (whose ``verify_batch_recover`` adds the
  time-scale ladder).
* Device rule: the verifiers are built with the pool's keyword arguments,
  so ``device=None`` (the default) means CUDA and raises without a card;
  pass ``device="cpu"`` for the CPU.  The TF32 switches are
  process-global, so the pool turns them off once at construction, not in
  each requesting thread.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from echoseal_torch.models.pipeline import BatchVerifier, RobustBatchVerifier


class VerifierPool:
    """LRU cache of per-key batched verifiers."""

    def __init__(self, *, profile: str = "compat", max_keys: int = 8,
                 **verifier_kwargs) -> None:
        if profile not in ("compat", "v2"):
            raise ValueError("profile must be 'compat' or 'v2'")
        if max_keys < 1:
            raise ValueError("max_keys must be >= 1")
        self.profile = profile
        self.max_keys = int(max_keys)
        self._kwargs = verifier_kwargs
        self._pool: OrderedDict[bytes, object] = OrderedDict()
        self._lock = threading.Lock()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------------ API
    def get(self, key32: bytes):
        """The (cached) batched verifier for this key."""
        with self._lock:
            v = self._pool.get(key32)
            if v is not None:
                self._pool.move_to_end(key32)
                return v
        cls = BatchVerifier if self.profile == "compat" else RobustBatchVerifier
        v = cls(key32, **self._kwargs)
        with self._lock:
            self._pool[key32] = v
            self._pool.move_to_end(key32)
            while len(self._pool) > self.max_keys:
                self._pool.popitem(last=False)
        return v

    def verify(self, key32: bytes, clips: np.ndarray,
               n_valid: np.ndarray | None = None, *,
               expected_nonce: bytes | None = None,
               recover_timescale: bool = False) -> np.ndarray:
        """(B, T) clips -> (B,) verdicts under ``key32``."""
        v = self.get(key32)
        if recover_timescale:
            if self.profile != "v2":
                raise ValueError("time-scale recovery is a v2 capability")
            return v.verify_batch_recover(clips, n_valid,
                                          expected_nonce=expected_nonce)
        return v.verify_batch(clips, n_valid, expected_nonce=expected_nonce)

    @property
    def cached_keys(self) -> list[bytes]:
        with self._lock:
            return list(self._pool.keys())
