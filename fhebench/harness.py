"""One run of one cell, found by name in ``BENCHMARK.json``.

The cell names its configuration (``configs[].file``) and its traffic mix
(``traffic/<mix>.json``); the mix names its operation, one of
``generator.OPS`` or the ``OP`` of ``ops/<op>.py``; each metric is read by
``metrics/<name>.py`` (a ``read(run)`` that returns a number, or None
where it finds nothing to read).  A run builds the engine and the inputs
from the seed, warms up, measures for ``seconds``, with ``trace`` profiles
a fixed number of requests after that, then frees the program's state and
holds the kept answers to the reference.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

import torch
from tiberate_tpu_torch.ops import cuda_build, ntt_kernels

from fhebench import generator, spans as spanlib, trace as tracelib
from fhebench.reference import ckks as ref

# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "tiberate_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Bench:
    """``BENCHMARK.json`` of a checkout and the files it names."""

    def __init__(self, root):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self.here = os.path.join(root, "fhebench")

    def cell(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def mix(self, name):
        with open(os.path.join(self.here, "traffic", f"{name}.json")) as f:
            return json.load(f)

    def metrics(self, cell, traced):
        """The cell's metrics: its end-to-end ones, or with ``traced`` its
        per-layer ones."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell]) and m["moves"] in moved]

    def reader(self, metric):
        """``metrics/<metric>.py``; where there is none, the reader of the
        name without its last ``.suffix``, and so on (``a.b.c`` falls back
        to ``a.b``, then ``a``)."""
        name = metric
        path = os.path.join(self.here, "metrics", f"{name}.py")
        while not os.path.exists(path) and "." in name:
            name = name.rsplit(".", 1)[0]
            path = os.path.join(self.here, "metrics", f"{name}.py")
        return load(path, "fhebench_metric_", name).read

    def op(self, name):
        """The operation a mix names: ``generator.OPS[name]`` for the
        three built in, else the ``OP`` (an ``Op`` subclass) of
        ``ops/<name>.py``."""
        if name in generator.OPS:
            return generator.OPS[name]
        path = os.path.join(self.here, "ops", f"{name}.py")
        if not os.path.exists(path):
            raise KeyError(f"no operation {name!r}: not one of "
                           f"{sorted(generator.OPS)}, and no file {path}")
        return load(path, "fhebench_op_", name).OP


def load(path, prefix, name):
    """The module of the source file ``path``, named ``prefix`` + ``name``
    with its dots and dashes as underscores."""
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, cell, config, mix):
        self.cell, self.config, self.mix = cell, config, mix
        self.requests = []
        self.window_s = None
        self.setup_s = None
        self.window_peak_bytes = None
        self.trace = None
        self.sm_clock_hz = None


def smi(*fields):
    """nvidia-smi's reading of the first card's ``fields``."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(fields)}",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return [x.strip() for x in out.splitlines()[0].split(",")]


def run_cell(root, workload, seed, seconds, traced, device, t_start=None,
             log=print):
    """Run one cell once; returns (result dict, checks)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(root)
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    device = torch.device(device)
    run = Run(cell, config, mix)

    # set-up: the kernels, the engine, keys and inputs, the warm-up
    if device.type == "cuda":
        cuda_build.lib()
    op = bench.op(mix["op"])(config, mix, seed, device)
    op.setup()
    sp = spanlib.Spans()
    for _ in range(int(mix["warmup"])):
        sp.begin()
        sp.end(op.request(sp))
    op.start_window()
    generator.sync(device)
    setup_peak = peak_bytes(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - t_start

    # the window: closed loop, one caller
    t0 = time.perf_counter()
    while True:
        sp.begin()
        run.requests.append(sp.end(op.request(sp)))
        if run.requests[-1].t1 - t0 >= seconds:
            break
    run.window_s = run.requests[-1].t1 - t0
    run.window_peak_bytes = peak_bytes(device)
    memory_peak = max(setup_peak or 0, run.window_peak_bytes or 0)
    log(f"window: {len(run.requests)} requests in {run.window_s:.3f} s; "
        f"set-up {run.setup_s:.3f} s")
    log(request_profile(run.requests))

    if device.type == "cuda":
        card = smi("name", "power.limit", "clocks.max.sm", "clocks.sm")
        log(f"card: {card[0]}, power limit {card[1]} W, SM clock "
            f"{card[3]} of at most {card[2]} MHz")
        run.sm_clock_hz = float(card[2]) * 1e6
    if traced:
        run.trace = tracelib.capture(op, sp, int(mix["profile_warmup"]),
                                     int(mix["profile_requests"]),
                                     lambda: ntt_kernels.LAUNCHES)
        log(f"trace: {run.trace.requests} requests, {run.trace.kernels} "
            f"kernels, the program's launches {run.trace.launches}")
        memory_peak = max(memory_peak, peak_bytes(device) or 0)

    metrics = {}
    for m in bench.metrics(workload, traced):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check: the program's state freed, the reference on the answers
    raw = generator.to64(op.answers())
    op.release()
    t_check = time.perf_counter()
    pr = ref.Params(config["primes"], config["logN"],
                    config["num_special_primes"], device,
                    config["scale_bits"], config.get("word_bits", 62))
    with torch.no_grad():
        try:
            checks = op.check(pr, raw, config["limits"])
        except (RuntimeError, ValueError, IndexError) as e:
            # answers the reference cannot even read (a wrong shape or
            # level): not correct, with the reason on standard error
            log(f"check failed: {traceback.format_exc()}")
            checks = [("answers_readable", type(e).__name__, "yes")]
    del raw, pr
    log(f"check: {time.perf_counter() - t_check:.3f} s")
    correct = all(isinstance(v, (int, float)) and v <= lim
                  for _, v, lim in checks)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]),
           "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(run.requests),
              "failed": 0 if correct else len(run.requests),
              "metrics": metrics, "device": dev}
    tr = run.trace
    if tr is not None and tr.window_s is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                               "idle_gaps": [list(x) for x in tr.idle_gaps]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result, checks


def request_profile(requests):
    """One line on where a run's time went: the requests' quantiles, the
    mean of each span, and the requests done in each second of the
    window (the host's speed drifts in phases of seconds)."""
    ts = sorted(1e3 * r.seconds for r in requests)

    def q(p):
        return ts[min(len(ts) - 1, int(p * len(ts)))]

    spans = {}
    for r in requests:
        for name, xs in r.spans.items():
            spans.setdefault(name, []).extend(xs)
    means = ", ".join(f"{k} {1e3 * sum(v) / len(v):.4f}"
                      for k, v in spans.items())
    t0 = requests[0].t0
    per_s = [0] * (int(requests[-1].t1 - t0) + 1)
    for r in requests:
        per_s[int(r.t1 - t0)] += 1
    return (f"requests, ms: p5 {q(0.05):.4f} p50 {q(0.5):.4f} p95 "
            f"{q(0.95):.4f} p99 {q(0.99):.4f} max {ts[-1]:.4f}; span means, "
            f"ms: {means}; done each second: {per_s}")


def peak_bytes(device):
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))
