"""Share of a profiled, steady run of ``verify_batch`` calls in which no
operation ran on the device (kernel, copy and set intervals of
``torch.profiler``), in %."""


def read(ctx):
    return ctx["profile"].get("idle_pct")
