"""Run one cell of the benchmark once, on the card this process sees.

    python3 fhebench/run.py --workload logN17-mult8 --seed 7 --seconds 20 \
        --trace 0

The last line of standard output is the result (one JSON object); the
numbers the check compared, each beside its limit, are the last lines of
standard error and the result's last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    cache = os.path.join(ROOT, "fhebench", "_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    import torch

    from fhebench import harness

    chips = harness.Bench(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fhebench: needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(f"fhebench: {msg}", file=sys.stderr, flush=True)

    result, checks = harness.run_cell(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
        "cuda:0", t_start=T_START, log=log)

    found = harness.forbidden_modules()
    if found:
        print(f"fhebench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 1
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
