"""``demod_ms`` in the v2 cells, where it moves
``audio_s_per_card_s``: the reader of ``demod_ms.py``."""
from pathlib import Path

from portbench import named

ROOT = Path(__file__).resolve().parents[2]
read = named.load("metrics", "demod_ms", ROOT).read
