"""Tracing and profiling helpers.

The torch counterpart of ``tiberate_tpu/utils/trace.py``:

* :func:`profile`: a context manager around ``torch.profiler.profile``
  over the CPU and, where a card is present, CUDA activities; on exit it
  writes a chrome trace (``trace_<pid>_<n>.json``) into ``logdir``.  The
  profiler runs one warm-up step first, whose records it discards: on a
  card the first launches after tracing starts can go unrecorded, so the
  caller's code runs only once tracing is live;
* :func:`annotate`: a named region inside a profile
  (``torch.profiler.record_function``), also an NVTX range when a card is
  present.

The JAX package's ``enable_xla_dumps`` and ``compiled_text`` have no
counterpart: the port compiles no graphs.  Nothing here costs anything
when unused.
"""

import contextlib
import itertools
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity
from torch.profiler import profile as _torch_profile
from torch.profiler import record_function, schedule

_traces = itertools.count()


def _default_logdir():
    return os.path.join(tempfile.gettempdir(), "tiberate_trace")


@contextlib.contextmanager
def profile(logdir: str | None = None):
    """Capture a trace: ``with profile(logdir): step()``.  Yields the path
    of the chrome trace it writes into ``logdir`` on exit (default: the
    ``tiberate_trace`` folder of the temporary directory)."""
    logdir = logdir or _default_logdir()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"trace_{os.getpid()}_{next(_traces)}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    warm_then_record = schedule(wait=0, warmup=1, active=1, repeat=1)
    with _torch_profile(activities=activities,
                        schedule=warm_then_record) as prof:
        if torch.cuda.is_available():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        prof.step()
        try:
            yield path
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str):
    """A named region inside a :func:`profile` (and an NVTX range on a
    card)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
