"""Host ms of the SCL ladder a ``verify_batch`` call: the program's
``verify.ladder`` span, 0 for a call that reached no rung, mean over the
calls of the program-span pass (``_program.py``)."""
from portbench.metrics._program import per_call_ms


def read(ctx):
    return per_call_ms(ctx, lambda name: name == "verify.ladder")
