"""Host ms per single-clip request in the scan (sync, filterbank, demod,
header; it ends in the host download): the program's ``Timer`` span
``rx.scan_stage``, mean over the window's requests."""
from portbench.metrics._spans import per_request_ms


def read(ctx):
    return per_request_ms(ctx, ("rx.scan_stage",))
