"""``sync_ms`` in the v2 cells, where it moves
``audio_s_per_card_s``: the reader of ``sync_ms.py``."""
from pathlib import Path

from portbench import named

ROOT = Path(__file__).resolve().parents[2]
read = named.load("metrics", "sync_ms", ROOT).read
