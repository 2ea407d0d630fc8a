"""``audio_s_per_s`` of the traced run's own window, in the v2 cells: the
audio seconds of every call of the window over the window's host seconds.
The v2 calls are host-bound, so this rate follows the host's speed, which
drifts from run to run by more than a bound can hold; the cells' end-to-end
rate is ``audio_s_per_card_s`` (``harness.end_to_end``)."""


def read(ctx):
    win = ctx.get("window")
    if not win or not win["window_s"]:
        return None
    return win["work"] / win["window_s"]
