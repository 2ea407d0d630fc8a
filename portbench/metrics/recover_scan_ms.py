"""Device ms of the time-scale scan a ``verify_batch_recover`` call: the
CUDA-event time of the program's ``recover.scan`` span (the scaled-template
FFT correlation of every clip the first pass rejected), 0 for a call that
scanned nothing, mean over the calls of the program-span pass."""
from portbench.metrics._recover import dev_ms_per_call


def read(ctx):
    return dev_ms_per_call(ctx, "recover.scan", "scan")
