"""Benchmark framework: typed results and a registry.

The torch counterpart of ``tiberate_tpu/extension/benchmarks/interface.py``:
benchmarks are classes whose ``run()`` returns a :class:`BenchmarkResult`
of typed metrics (scalars, tables, distributions, series), found through a
registry and run from the CLI.  Latency is always reported beside the
decrypt-vs-plain error.  :meth:`BenchmarkBase.timeit` synchronises the
card (``torch.cuda.synchronize``) around its timed loop.
"""

import json
import time
from dataclasses import dataclass, field
from enum import Enum

import torch


def sync():
    """Wait for the card's queued work (CPU tensors compute eagerly)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class MetricKind(Enum):
    SCALAR = "scalar"
    SERIES = "series"  # x/y pairs (the reference's "plot")
    TABLE = "table"
    DISTRIBUTION = "distribution"


@dataclass
class Metric:
    name: str
    kind: MetricKind
    value: object
    unit: str = ""

    def to_json(self):
        return {
            "name": self.name,
            "kind": self.kind.value,
            "value": self.value,
            "unit": self.unit,
        }


@dataclass
class BenchmarkResult:
    name: str
    metrics: list = field(default_factory=list)
    started_at: float = field(default_factory=time.time)
    notes: str = ""

    def add_scalar(self, name, value, unit=""):
        self.metrics.append(Metric(name, MetricKind.SCALAR, value, unit))

    def add_series(self, name, xs, ys, unit=""):
        self.metrics.append(
            Metric(name, MetricKind.SERIES, {"x": list(xs), "y": list(ys)},
                   unit)
        )

    def add_table(self, name, columns, rows):
        self.metrics.append(
            Metric(
                name, MetricKind.TABLE,
                {"columns": list(columns), "rows": [list(r) for r in rows]},
            )
        )

    def add_distribution(self, name, values, unit=""):
        import numpy as np

        v = np.asarray(values, dtype=float)
        self.metrics.append(
            Metric(
                name, MetricKind.DISTRIBUTION,
                {
                    "mean": float(v.mean()),
                    "std": float(v.std()),
                    "min": float(v.min()),
                    "max": float(v.max()),
                    "n": int(v.size),
                },
                unit,
            )
        )

    def to_json(self):
        return {
            "name": self.name,
            "started_at": self.started_at,
            "notes": self.notes,
            "metrics": [m.to_json() for m in self.metrics],
        }

    def dumps(self):
        return json.dumps(self.to_json(), indent=2)

    def print_terminal(self):
        print(f"=== {self.name} ===")
        for m in self.metrics:
            if m.kind == MetricKind.SCALAR:
                print(f"  {m.name}: {m.value} {m.unit}")
            elif m.kind == MetricKind.SERIES:
                pairs = list(zip(m.value["x"], m.value["y"]))
                print(f"  {m.name} ({m.unit}): {pairs}")
            elif m.kind == MetricKind.TABLE:
                print(f"  {m.name}:")
                cols = m.value["columns"]
                print("    " + " | ".join(str(c) for c in cols))
                for row in m.value["rows"]:
                    print("    " + " | ".join(str(x) for x in row))
            elif m.kind == MetricKind.DISTRIBUTION:
                d = m.value
                print(
                    f"  {m.name}: mean={d['mean']:.4g} std={d['std']:.4g} "
                    f"min={d['min']:.4g} max={d['max']:.4g} (n={d['n']}) "
                    f"{m.unit}"
                )


class BenchmarkBase:
    """Subclass and implement run(); register with @benchreg.register."""

    name = "unnamed"
    description = ""

    def run(self, **kwargs) -> BenchmarkResult:
        raise NotImplementedError

    @staticmethod
    def timeit(fn, iters=10, warmup=2):
        """Seconds per call of ``fn`` over ``iters`` calls after
        ``warmup`` ones, the card synchronised before and after."""
        for _ in range(warmup):
            fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        return (time.perf_counter() - t0) / iters


class _BenchRegistry(dict):
    def register(self, cls):
        self[cls.name] = cls
        return cls


benchreg = _BenchRegistry()
