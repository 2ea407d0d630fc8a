"""Host ms per single-clip request in the decode pass (one
``payload_decode`` launch and the CRC-passing rows' download) and the AEAD
opens: the program's ``Timer`` spans ``rx.llr_stage`` + ``rx.aead_open``,
mean over the window's requests."""
from portbench.metrics._spans import per_request_ms


def read(ctx):
    return per_request_ms(ctx, ("rx.llr_stage", "rx.aead_open"))
