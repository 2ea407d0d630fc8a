"""Host ms of the SCL ladder per ``verify_batch`` call: the rung seconds
of ``scl_rungs`` (emptied before each call) summed, mean over the calls of
the window, calls that reached no rung counted as 0."""


def read(ctx):
    rungs = ctx.get("rungs")
    if not rungs or not hasattr(ctx["runner"].verifier, "scl_rungs"):
        return None
    return 1e3 * sum(sum(r[3] for r in call) for call in rungs) / len(rungs)
