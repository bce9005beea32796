"""Tracing and profiling helpers.

The torch counterpart of ``tiberate_tpu/utils/trace.py``:

* :func:`profile`: a context manager around ``torch.profiler.profile``
  over the CPU and, where a card is present, CUDA activities; on exit it
  writes a chrome trace (``trace_<pid>_<n>.json``) into ``logdir`` and
  yields that file's path (the JAX one yields the directory: the port
  writes one file a profile).  The profiler runs one warm-up step first,
  whose records it discards: on a card the first launches after tracing
  starts can go unrecorded, so the caller's code runs only once tracing
  is live;
* :func:`annotate`: the program's span.  It records only while a torch
  profiler records (``torch._C._autograd._profiler_enabled()``; false in
  a profiler schedule's warm-up steps); otherwise it costs that one check.
  While a profiler records, a span is a ``record_function`` range (a
  ``user_annotation`` in the chrome trace, on the profiler's clock beside
  the kernels and their launches) and an in-memory record;
* :func:`spans` and :func:`clear`: the records.

A record (``_Record``) holds ``name``; ``t0`` and ``t1`` in
``time.perf_counter()`` seconds; ``index``, its number since the last
:func:`clear`; ``parent``, the enclosing span's index (None for a root,
a span opened with none open); ``root``, the root's index, shared by
every span of one top-level call; ``launches``, the CUDA kernels the
port launched inside the span (on a CPU tensor, those its plain versions
stood in for); and, on a root, ``first_launch``: the ``perf_counter()``
time its first launch returned, or None.  Records are
kept in the order spans open, at most ``_MAX_RECORDS``: past that the
oldest are dropped, and the first kept record's ``index`` is the number
dropped.  One thread records.

The JAX package's ``enable_xla_dumps`` and ``compiled_text`` have no
counterpart: the port compiles no graphs.
"""

import collections
import contextlib
import itertools
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity
from torch.profiler import profile as _torch_profile
from torch.profiler import record_function, schedule

_traces = itertools.count()
_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_MAX_RECORDS = 1 << 16

_records = collections.deque(maxlen=_MAX_RECORDS)
_next = 0         # index of the next record
_open = []        # the open spans' records, innermost last
_root = None      # the open root's record; None: no span open
_launches = 0     # the port's launches counted while a root was open


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


class _Record:
    __slots__ = ("name", "index", "parent", "root", "t0", "t1", "launches",
                 "first_launch")


class _Span:
    """One span while a profiler records."""

    __slots__ = ("name", "rec", "rf", "n0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _next, _root
        rec = self.rec = _Record()
        rec.name = self.name
        rec.index = _next
        _next += 1
        parent = _open[-1] if _open else None
        rec.parent = None if parent is None else parent.index
        rec.root = rec.index if parent is None else parent.root
        rec.t1 = rec.launches = rec.first_launch = None
        if parent is None:
            _root = rec
        _records.append(rec)
        _open.append(rec)
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.n0 = _launches
        rec.t0 = time.perf_counter()

    def __exit__(self, *exc):
        global _root
        rec = self.rec
        rec.t1 = time.perf_counter()
        rec.launches = _launches - self.n0
        self.rf.__exit__(*exc)
        _open.pop()
        if not _open:
            _root = None


def annotate(name: str):
    """A span named ``name``: ``with annotate("cc_mult"): ...``.  Records
    only while a torch profiler records (see the module's docstring)."""
    if not _recording():
        return _OFF
    return _Span(name)


def _launched(kernels):
    """``kernels`` CUDA kernels of the port launched while a root is open
    (the launch sites check ``_root``): counted, and the root's first
    launch stamped."""
    global _launches
    _launches += kernels
    if _root.first_launch is None:
        _root.first_launch = time.perf_counter()


def spans() -> list:
    """The kept records, in the order their spans opened."""
    return list(_records)


def clear():
    """Drop every record and number the next one 0 (spans still open keep
    recording into the records they hold)."""
    global _next
    _records.clear()
    _next = 0
