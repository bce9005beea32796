"""What the metric readers (``metrics/<name>.py``) share: each turns a
:class:`harness.Run` into one number, or None where it finds nothing to
read."""

from fhebench.roofline import work


def rate(run, unit):
    """``unit`` of work completed over the whole window, a second."""
    done = sum(r.work.get(unit, 0) for r in run.requests)
    return done / run.window_s if done and run.window_s else None


def idle_pct(run):
    """100 (1 - union of device activity / traced window)."""
    tr = run.trace
    if tr is None or not tr.busy_s or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_pct(run, op):
    """The least time of one request of ``op`` (``work.cc_mult`` or
    ``work.rot_sum``) over its kernels' device time, in %."""
    tr = run.trace
    if tr is None or not tr.kernel_s or run.sm_clock_hz is None:
        return None
    c = run.config
    w = op(c["logN"], len(c["primes"]) - c["num_special_primes"],
           c["num_special_primes"], int(run.mix.get("level", 0)),
           int(run.mix["batch"]))
    return 100.0 * w.least_s(run.sm_clock_hz) / (tr.kernel_s / tr.requests)


def kernels_per(run, per_request):
    """Kernel launches in the trace per request, divided by
    ``per_request``."""
    tr = run.trace
    if tr is None or not tr.kernels:
        return None
    return tr.kernels / tr.requests / per_request


def span_mean_ms(run, name):
    """Mean of a benchmark span over the window's requests, in ms."""
    xs = [t for r in run.requests for t in r.spans.get(name, ())]
    return 1e3 * sum(xs) / len(xs) if xs else None

