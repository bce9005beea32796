"""A device trace of a fixed number of requests, and its reduction.

``torch.profiler`` records the CPU and the card over ``warmup`` requests,
which it discards, then ``active`` requests; the chrome trace is written
into the temporary directory, read back and deleted.  The traced window
runs from the first active request's start to the last one's end (the
benchmark's ``request`` ranges).  The card's idle gaps are named by the
benchmark spans that the active requests opened (``Request.spans``).
"""

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short(name):
    """A kernel's name without ``void`` and its parameter list."""
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i:
            return name[:i].strip()
    return name.strip()


def union(intervals):
    """Total length of the union of (start, end) intervals, and the
    merged intervals in order."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


class Trace:
    """The reduction of one profile (times in seconds)."""

    def __init__(self, events, span_names, requests, launches):
        self.requests = requests
        self.launches = launches   # the program's own counter, per kernel
        req = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == "request"]
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and "ts" in e and "dur" in e]
        self.kernels = sum(e["cat"] == "kernel" for e in dev)
        self.kernel_s = sum(e["dur"] for e in dev
                            if e["cat"] == "kernel") * 1e-6
        if not req:
            self.window_s = self.busy_s = None
            self.device_ops = self.idle_gaps = []
            return
        t0 = min(e["ts"] for e in req)
        t1 = max(e["ts"] + e["dur"] for e in req)
        self.window_s = (t1 - t0) * 1e-6
        busy, merged = union((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                             for e in dev if e["ts"] < t1
                             and e["ts"] + e["dur"] > t0)
        self.busy_s = busy * 1e-6
        by_name = {}
        for e in dev:
            n = short(e["name"])
            by_name[n] = by_name.get(n, 0) + e["dur"] * 1e-6
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        # idle gaps on the card, named by the innermost benchmark span that
        # holds the gap's middle on the host
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") in span_names]
        edges = [t0] + [x for ab in merged for x in ab] + [t1]
        gaps = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inner = [e for e in spans if e["ts"] <= mid <= e["ts"] + e["dur"]]
            name = (min(inner, key=lambda e: e["dur"])["name"] if inner
                    else "between requests")
            gaps[name] = gaps.get(name, 0) + (b - a) * 1e-6
        self.idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]


def capture(op, spans, warmup, active, counter):
    """Profile ``warmup`` + ``active`` requests of ``op``; ``counter()``
    reads the program's launch counts (a dict)."""
    from torch.profiler import ProfilerActivity, profile, record_function, \
        schedule

    acts = [ProfilerActivity.CPU]
    if op.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    spans.annotate = True
    before = None
    names = set()
    try:
        with profile(activities=acts, schedule=schedule(
                wait=0, warmup=warmup, active=active, repeat=1)) as prof:
            for i in range(warmup + active):
                if i == warmup:
                    before = dict(counter())
                spans.begin()
                with record_function("request"):
                    work = op.request(spans)
                req = spans.end(work)
                if i >= warmup:
                    names |= set(req.spans)
                prof.step()
        after = counter()
    finally:
        spans.annotate = False
    fd, path = tempfile.mkstemp(prefix="fhebench_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    launches = {k: after[k] - before.get(k, 0) for k in after
                if after[k] - before.get(k, 0)}
    return Trace(events, names, active, launches)
