"""Host ms of ``finish_host(out)`` on the outputs of a marked
``run_device``, per batch, mean of the marked passes."""


def read(ctx):
    m = ctx.get("marked")
    if not m or not m["finish_s"]:
        return None
    return 1e3 * sum(m["finish_s"]) / len(m["finish_s"])
