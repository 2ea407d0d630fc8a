"""Device ms of the speed corrections a ``verify_batch_recover`` call: the
CUDA-event times of the program's ``recover.resample`` spans (one polyphase
resample a lattice denominator and round), summed, mean over the calls of
the program-span pass."""
from portbench.metrics._recover import dev_ms_per_call


def read(ctx):
    return dev_ms_per_call(ctx, "recover.resample", "resample")
