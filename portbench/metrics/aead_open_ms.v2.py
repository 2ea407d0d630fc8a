"""``aead_open_ms`` in the v2 cells, where it moves
``audio_s_per_card_s``: the reader of ``aead_open_ms.py``."""
from pathlib import Path

from portbench import named

ROOT = Path(__file__).resolve().parents[2]
read = named.load("metrics", "aead_open_ms", ROOT).read
