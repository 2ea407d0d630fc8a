"""Device ms of the demod stage per batch: the CUDA-event mark
``demod_refine`` (compat) or ``demod`` (v2), mean of the marked passes."""


def read(ctx):
    m = ctx.get("marked")
    if not m:
        return None
    xs = [s.get("demod_refine", s.get("demod")) for s in m["stages"]]
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None
