"""Frozen copy of ``echoseal_torch/core/params.py`` for the benchmark's traffic and
plain reference (it does not move with the program).

Frame-format constants and TX/RX parameter containers.

Ground-truth frame layout (matches the reference on-air format, see
rtwm/embedder.py:104-127 and rtwm/detector.py:13-19):

    | preamble | header | payload |
    |   63     |  128   |  1024   |  chips  -> FRAME_LEN = 1215

* preamble: MLS-63, BPSK, unspread
* header:   16-bit ``frame_ctr & 0xFFFF`` (MSB-first), each bit repeated 8x,
            BPSK, XOR-spread by the frame-0 PN (counter independent)
* payload:  Polar(N=1024, K=448) codeword of the 55-byte sealed blob, BPSK,
            spread by the per-frame PN slice [191:1215]

One chip == one sample at fs=48 kHz, so a frame spans ~25.3 ms.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# ---------------------------------------------------------------- frame plan
FS_DEFAULT = 48_000

PRE_L = 63            # MLS-63 preamble chips
HDR_BITS = 16         # counter low bits carried in the header
HDR_REPEAT = 8        # repetition factor per header bit
HDR_L = HDR_BITS * HDR_REPEAT  # 128 header chips

N_DEFAULT = 1024      # polar codeword length (payload chips)
K_DEFAULT = 448       # info + CRC bits (440 info = 55 bytes, 8 CRC)
CRC_SIZE = 8          # CRC-8, poly 0x07
PAYLOAD_BYTES = (K_DEFAULT - CRC_SIZE) // 8  # 55-byte sealed blob

FRAME_LEN = PRE_L + HDR_L + N_DEFAULT  # 1215 chips

# sealed blob layout: nonce(12) || ciphertext(27) || tag(16)
NONCE_BYTES = 12
TAG_BYTES = 16
PLAINTEXT_BYTES = PAYLOAD_BYTES - NONCE_BYTES - TAG_BYTES  # 27
MAGIC = b"ESAL"
SESSION_NONCE_BYTES = 8

# ------------------------------------------------------------ detector knobs
TIGHT_DELTA = 3       # quick +-3 counter search around the time estimate
WIDE_DELTA = 200      # one-time wide fallback window
MAX_TRIES = 400       # decode-attempt budget per band pass
PEAK_LIMIT = 25       # correlation peaks examined per band pass
MIN_PEAK_FALLBACK = 5 # top-K fallback when nothing clears the CFAR threshold
SCL_LIST_DEFAULT = 256

# ---------------------------------------------------------------- mixer law
EPS = 1e-12
MIX_HEADROOM = 0.98
TARGET_REL_DB = -10.0     # watermark level relative to host RMS
FLOOR_REL_DBFS = -35.0    # absolute floor so silence still carries watermark
FRAME_PEAK_GUARD = 3.0    # per-frame renormalisation threshold


@dataclasses.dataclass(slots=True)
class TxParams:
    """Transmitter configuration (mirrors the reference TxParams surface)."""

    fs: int = FS_DEFAULT
    target_rel_db: float = TARGET_REL_DB
    floor_rel_dbfs: float = FLOOR_REL_DBFS
    N: int = N_DEFAULT
    K: int = K_DEFAULT
    preamble: np.ndarray | None = None

    def __post_init__(self) -> None:
        if self.preamble is None:
            from .sequences import mls63

            self.preamble = mls63()


@dataclasses.dataclass(slots=True)
class RxParams:
    """Receiver configuration."""

    fs_target: int = FS_DEFAULT
    list_size: int = SCL_LIST_DEFAULT
    tight_delta: int = TIGHT_DELTA
    wide_delta: int = WIDE_DELTA
    max_tries: int = MAX_TRIES
    peak_limit: int = PEAK_LIMIT
    # Reference parity knob: the reference detector accepts an UNSEALED
    # payload whose first 4 bytes spell the magic (rtwm/detector.py:206-212
    # "legacy plaintext").  That path bypasses AEAD entirely, so it is a
    # config decision, not a hardcoded behavior: default True here (parity
    # for the single-clip detector), default False in the serving pipeline
    # (models/pipeline.py), where the SCL/extended-counter fan-out routes
    # far more decoder candidates through acceptance.
    accept_legacy_plaintext: bool = True
    # TPU additions (not in the reference):
    scl_budget: int = 64     # max candidates sent through the SCL ladder
    scl_batch: int = 32      # SCL dispatch batch size
    timescale_grid: Tuple[float, ...] = ()  # optional time-scale search grid
    # longest stream (in frames) whose clips are still absolutely
    # resolvable via the 16-bit header: lo16 + m*2^16 is fanned out for
    # m < ceil(max_stream_frames / 2^16).  Default 2^20 frames ~ 7.4 h
    # @ 39.5 frames/s; raise it for longer sessions (host-side cost only).
    max_stream_frames: int = 1 << 20
