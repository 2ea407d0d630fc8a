"""Native streaming TX: Python frame synthesis feeding the C ring mixer.

The real-time constraint of the TX path is the audio callback (~21 ms per
1024-sample block).  Here the callback does no Python numeric work: it
calls ``NativeMixer.process``, whose C side reads chips from the lock-free
ring and applies the mix law without allocating.  A daemon feeder thread
keeps the ring topped up with frames rendered by the ordinary host
synthesis (``WatermarkEmbedder._make_frame_chips``: seal, polar, PN, IIR),
which then has several frame periods of slack instead of a callback
deadline.

Used by ``tx_app --native``, which takes the Python mixer where no C
compiler is present (``native.available()``).
"""
from __future__ import annotations

import threading
import time

import numpy as np

from echoseal_torch.core.params import FRAME_LEN, MIX_HEADROOM, TxParams
from echoseal_torch.models.embedder import WatermarkEmbedder
from echoseal_torch.native import NativeMixer


class NativeStreamEmbedder:
    """``WatermarkEmbedder``'s ``process(block)`` surface on the C mixer.

    Keeps the TX session state of a ``WatermarkEmbedder`` (frame counter,
    session nonce, key schedule): the ring carries exactly the chip stream
    that the Python mixer would mix.  ``rng`` (a ``numpy.random.Generator``)
    goes to that embedder, which then draws every random byte from it, so
    the stream is reproducible; every frame is rendered under one lock
    (``_produce``), in counter order, whichever thread renders it.
    """

    #: keep at least this many chips buffered (~4 frames, ~100 ms)
    LOW_WATER = 4 * FRAME_LEN

    def __init__(self, key32: bytes, params: TxParams | None = None, *,
                 rng: np.random.Generator | None = None) -> None:
        self._tx = WatermarkEmbedder(key32, params, rng=rng)
        p = self._tx.p
        self._mixer = NativeMixer(target_rel_db=p.target_rel_db,
                                  floor_rel_dbfs=p.floor_rel_dbfs,
                                  headroom=MIX_HEADROOM)
        self._stop = threading.Event()
        # serialises the ring's producer side between the feeder thread
        # and the synchronous top-up in process()
        self._produce = threading.Lock()
        self._feeder = threading.Thread(target=self._feed, daemon=True,
                                        name="echoseal-tx-feeder")
        self._feeder.start()

    # ------------------------------------------------------------------ API
    @property
    def p(self) -> TxParams:
        """TX parameters (the CLI and ``AudioLoop`` read ``p.fs``)."""
        return self._tx.p

    @property
    def frame_ctr(self) -> int:
        return self._tx.frame_ctr

    @property
    def session_nonce(self) -> bytes:
        return self._tx._session_nonce

    def process(self, samples: np.ndarray) -> np.ndarray:
        """Mix one block: one C call when the ring is stocked.

        If the ring cannot cover the block (a consumer faster than the
        feeder, e.g. the offline ``NullAudioLoop``), frames are rendered
        here before mixing, so the output is always fully watermarked.
        """
        x = np.asarray(samples, dtype=np.float32).ravel()
        if self._mixer.available_chips < x.size:
            with self._produce:
                while (self._mixer.available_chips < x.size
                       and self._mixer.space >= FRAME_LEN):
                    self._push_frame()
        out, _used = self._mixer.process(x)
        return out

    def close(self) -> None:
        """Stop the feeder thread."""
        self._stop.set()
        self._feeder.join(timeout=1.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- feeder
    def _push_frame(self) -> None:
        """Render and enqueue one frame (callers hold ``_produce``)."""
        chips = self._tx._make_frame_chips()
        self._tx.frame_ctr = (self._tx.frame_ctr + 1) % (2**32)
        self._mixer.push_chips(chips)

    def _feed(self) -> None:
        while not self._stop.is_set():
            if (self._mixer.available_chips < self.LOW_WATER
                    and self._mixer.space >= FRAME_LEN):
                with self._produce:
                    if (self._mixer.available_chips < self.LOW_WATER
                            and self._mixer.space >= FRAME_LEN):
                        self._push_frame()
            else:
                # ring full enough: sleep well under one frame period
                time.sleep(0.002)
