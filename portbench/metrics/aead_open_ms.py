"""Host ms of AEAD opens a ``verify_batch`` call: the program's ``*.open``
spans (hard rows, other candidates, SCL rungs, extended counters) summed,
mean over the calls of the program-span pass (``_program.py``)."""
from portbench.metrics._program import per_call_ms


def read(ctx):
    return per_call_ms(ctx, lambda name: name.endswith(".open"))
