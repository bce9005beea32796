"""The step's prelude: the mean over the traced steps of the program's
``cc_mult`` span from its start to its first launch, in ms: host time
with the card idle in a closed loop (``align_level``, the step's key and
parameters, the first wrapper's checks)."""

from fhebench import program


def read(run):
    rs = program.roots(run, "cc_mult")
    xs = [r.first_launch - r.t0 for r in rs if r.first_launch is not None]
    return 1e3 * sum(xs) / len(xs) if xs else None
