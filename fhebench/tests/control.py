"""The control: every cell run with its configuration's 30-bit twin (the
program's own lower-precision lane: int32 residues, 25-bit scale primes,
``"logN17_30"`` beside ``"logN17"``) in the program's place, and held to
the 62-bit configuration's limits, which it has to fail.

On the card, at the cells' own sizes (one process, several seeds):

    python3 -m fhebench.tests.control --cells logN17-mult8 logN15-mult8 \
        --seeds 101 102 103 --seconds 2
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

from fhebench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def twin(config):
    """The 30-bit twin of a preset configuration, with the same limits."""
    from tiberate_tpu_torch.config import CkksConfig

    c = CkksConfig.parse(config["preset"] + "_30")
    out = dict(config, preset=config["preset"] + "_30",
               num_special_primes=c.num_special_primes,
               scale_bits=c.scale_bits, word_bits=30,
               primes=[int(q) for q in c.q])
    out.pop("num_scales", None)
    return out


def checkout(tmp, configs):
    """A copy of the benchmark under ``tmp`` whose configuration files are
    ``configs`` (name -> dict)."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(HERE, os.path.join(root, "fhebench"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    bench = harness.Bench(root)
    for c in bench.spec["configs"]:
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(configs[c["name"]], f)
    return root


def readings(cells, seeds, seconds, device, root=ROOT, log=print):
    """{cell: [(seed, correct, {check: value})]} of the control."""
    bench = harness.Bench(root)
    configs = {c["name"]: twin(bench.config(c["name"]))
               for c in bench.spec["configs"]}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        croot = checkout(tmp, configs)
        for cell in cells:
            for seed in seeds:
                res, checks = harness.run_cell(croot, cell, seed, seconds,
                                               False, device,
                                               log=lambda m: None)
                row = (seed, res["correct"], {n: v for n, v, _ in checks})
                out.setdefault(cell, []).append(row)
                log(f"control {cell} seed {seed}: correct {res['correct']} "
                    f"{row[2]}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    res = readings(args.cells, args.seeds, args.seconds, "cuda:0")
    print(json.dumps(res))
    return 0 if all(not ok for rows in res.values()
                    for _, ok, _ in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
