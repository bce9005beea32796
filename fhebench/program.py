"""What the readers of the program's own spans share: the traced
requests' root spans, from ``tiberate_tpu_torch.utils.trace``.

The program records its spans only while a profiler records, so its
records that start after the window's last request are the traced
requests': the root spans each request opened (one in the cells that
exist, ``cc_mult`` or ``sum``).  They are read only beside a device
trace that holds kernels: without a card there is no launch to wait
for.  A program without the records (``trace.spans``) gives none, and
its readers return None.
"""

from tiberate_tpu_torch.utils import trace


def roots(run, name=None):
    """The traced requests' root spans named ``name``, in order; every
    root span where ``name`` is None."""
    tr = run.trace
    spans = getattr(trace, "spans", None)
    if tr is None or not tr.kernels or spans is None:
        return []
    t_end = run.requests[-1].t1
    return [r for r in spans()
            if r.parent is None and name in (None, r.name) and r.t0 > t_end]


def torch_launches(run, per_request):
    """The trace's kernels a request less the program's own CUDA kernels
    that every root span counted a request, over ``per_request``: the
    launches of torch's own ops.  A request may open any number of roots
    of any name."""
    rs = roots(run)
    if not rs:
        return None
    tr = run.trace
    own = sum(r.launches for r in rs) / tr.requests
    return (tr.kernels / tr.requests - own) / per_request
