"""Host ms per single-clip request in the host candidate ladder and the PN
fan-out: the program's ``Timer`` spans ``rx.candidates`` +
``rx.pn_fanout``, mean over the window's requests."""
from portbench.metrics._spans import per_request_ms


def read(ctx):
    return per_request_ms(ctx, ("rx.candidates", "rx.pn_fanout"))
