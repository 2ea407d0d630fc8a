"""Soft rows list-decoded per clip the SCL ladder rescued: the ``rows`` of
the program's ``ladder.rung`` spans over the ``rescued`` of its
``verify.ladder`` spans, summed over the program-span pass
(``_program.py``); None where the ladder rescued nothing."""
from portbench.metrics._program import program


def read(ctx):
    prog = program(ctx)
    if not prog:
        return None

    def total(name, key):
        return sum(s["attrs"].get(key, 0) for s in prog["spans"]
                   if s["name"] == name)

    rescued = total("verify.ladder", "rescued")
    return total("ladder.rung", "rows") / rescued if rescued else None
