"""``host_wait_ms`` in the v2 cells, where it moves
``audio_s_per_card_s``: the reader of ``host_wait_ms.py``."""
from pathlib import Path

from portbench import named

ROOT = Path(__file__).resolve().parents[2]
read = named.load("metrics", "host_wait_ms", ROOT).read
