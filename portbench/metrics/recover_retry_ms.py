"""Host ms of the retry rounds a ``verify_batch_recover`` call: the
program's ``recover.round`` spans (resample, re-verify with its ladder,
refinement of the next factors; each round's own, without the next),
summed, mean over the calls of the program-span pass."""
from portbench.metrics._recover import per_call


def read(ctx):
    def ms(s):
        return 1e-6 * (s["end_ns"] - s["start_ns"])
    return per_call(ctx, "recover.round", ms)
