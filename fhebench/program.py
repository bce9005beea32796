"""What the readers of the program's own spans share: the traced
requests' root spans, from ``tiberate_tpu_torch.utils.trace``.

The program records its spans only while a profiler records, so its
records that start after the window's last request are the traced
requests', one root span a request (``cc_mult``, ``sum``).  They are read
only beside a device trace that holds kernels: without a card there is no
launch to wait for.  A program without the records (``trace.spans``)
gives none, and its readers return None.
"""

from tiberate_tpu_torch.utils import trace


def roots(run, name):
    """The traced requests' root spans named ``name``, in order."""
    tr = run.trace
    spans = getattr(trace, "spans", None)
    if tr is None or not tr.kernels or spans is None:
        return []
    t_end = run.requests[-1].t1
    return [r for r in spans()
            if r.parent is None and r.name == name and r.t0 > t_end]


def torch_launches(run, per_request):
    """The trace's kernels a request less the program's own CUDA kernels
    that the roots counted a request, over ``per_request``: the launches
    of torch's own ops.  The roots are named by the mix's operation
    (``cc_mult``, ``sum``)."""
    rs = roots(run, run.mix["op"])
    if not rs:
        return None
    tr = run.trace
    own = sum(r.launches for r in rs) / len(rs)
    return (tr.kernels / tr.requests - own) / per_request
