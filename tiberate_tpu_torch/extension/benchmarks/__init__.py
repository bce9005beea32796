"""The benchmark registry; importing the package imports every ``bench_*``
module in it, so their registrations run."""

import importlib
import pkgutil

from tiberate_tpu_torch.extension.benchmarks.interface import (
    BenchmarkBase,
    BenchmarkResult,
    Metric,
    MetricKind,
    benchreg,
)

# Auto-import every bench_* module in this package so registrations run.
for _mod in pkgutil.iter_modules(__path__):
    if _mod.name.startswith("bench_"):
        importlib.import_module(f"{__name__}.{_mod.name}")

__all__ = [
    "BenchmarkBase",
    "BenchmarkResult",
    "Metric",
    "MetricKind",
    "benchreg",
]
