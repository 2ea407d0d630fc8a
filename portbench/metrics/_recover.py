"""The recovery cell's readers of the program's spans: a value of some
spans summed, mean over the calls of the program-span pass
(``_program.py``); None where the program has no ``verify_batch_recover``
span (a program without the recovery's spans)."""
from portbench.metrics._program import program


def per_call(ctx, name, value):
    """Sum of ``value(span)`` over the spans named ``name``, over calls."""
    prog = program(ctx)
    if not prog or not prog["calls"] or not any(
            s["name"] == "verify_batch_recover" for s in prog["spans"]):
        return None
    return sum(value(s) for s in prog["spans"]
               if s["name"] == name) / prog["calls"]


def dev_ms_per_call(ctx, name, mark):
    """Device ms a call of the spans ``name``: their CUDA-event time
    ``attrs["dev_ms"][mark]``; None where no such span carries one (no
    card)."""
    prog = program(ctx)
    if not prog or not any(mark in s["attrs"].get("dev_ms", {})
                           for s in prog["spans"] if s["name"] == name):
        return None
    return per_call(ctx, name,
                    lambda s: s["attrs"].get("dev_ms", {}).get(mark, 0.0))
