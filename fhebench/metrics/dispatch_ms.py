"""The step's host dispatch: the mean duration of the program's
``cc_mult`` span over the traced steps, in ms (the call returns once its
launches are queued: a CUDA graph or cheaper wrappers cut this)."""

from fhebench import program


def read(run):
    rs = program.roots(run, "cc_mult")
    return 1e3 * sum(r.t1 - r.t0 for r in rs) / len(rs) if rs else None
