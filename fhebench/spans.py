"""The benchmark's own spans: host-clock intervals around its calls into
the program, kept in memory per request.  While a profile is taken they
are also ``record_function`` ranges, so the trace carries them."""

import contextlib
import time

import torch


class Request:
    """One closed-loop request: its start and end, the work it completed
    and its spans by name."""

    __slots__ = ("t0", "t1", "work", "spans")

    def __init__(self, t0):
        self.t0 = t0
        self.t1 = None
        self.work = {}
        self.spans = {}

    @property
    def seconds(self):
        return self.t1 - self.t0


class Spans:
    def __init__(self):
        self.annotate = False
        self.current = None

    def begin(self):
        self.current = Request(time.perf_counter())
        return self.current

    def end(self, work):
        req = self.current
        req.t1 = time.perf_counter()
        req.work = work
        self.current = None
        return req

    @contextlib.contextmanager
    def span(self, name):
        ctx = (torch.profiler.record_function(name) if self.annotate
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        if self.current is not None:
            self.current.spans.setdefault(name, []).append(
                time.perf_counter() - t0)
