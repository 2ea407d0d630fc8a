"""Rows a ``verify_batch_recover`` call re-verified over all its retry
rounds: the ``retry_rows`` counter on the program's root span, mean over
the calls of the program-span pass."""
from portbench.metrics._recover import per_call


def read(ctx):
    return per_call(ctx, "verify_batch_recover",
                    lambda s: s["attrs"].get("retry_rows", 0))
