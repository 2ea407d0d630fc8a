"""Host ms a ``verify_batch`` call waits on the card: the program's
``*.download`` spans (each ``.cpu()`` of a device tensor in the call, the
one behind the whole device stage included) summed, mean over the calls
of the program-span pass (``_program.py``)."""
from portbench.metrics._program import per_call_ms


def read(ctx):
    return per_call_ms(ctx, lambda name: name.endswith(".download"))
