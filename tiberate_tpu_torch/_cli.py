"""Command-line interface, the counterpart of ``tiberate_tpu/_cli.py``:

    python -m tiberate_tpu_torch version
    python -m tiberate_tpu_torch list-benchmarks
    python -m tiberate_tpu_torch benchmark [--name NAME] [--preset P]
        [--iters N] [--file F] [--all] [--device cuda|cpu]

``--device`` (default "cuda") is where the benchmarks' engines run; "cpu"
runs the kernels' plain torch versions.  Without ``--name`` or ``--all``
the benchmark command opens the curses selector on a TTY and a numbered
prompt elsewhere.
"""

import argparse
import json
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="tiberate-tpu-torch")
    sub = parser.add_subparsers(dest="cmd")

    sub.add_parser("version", help="print the version")

    p_bench = sub.add_parser("benchmark", help="run benchmarks")
    p_bench.add_argument("--name", default=None,
                         help="benchmark name (default: interactive/all)")
    p_bench.add_argument("--preset", default="logN15",
                         help="logN14 .. logN17, logN15_30, logN17_30, or toy")
    p_bench.add_argument("--iters", type=int, default=10)
    p_bench.add_argument("--file", default=None,
                         help="write results as json to this path")
    p_bench.add_argument("--all", action="store_true",
                         help="run every registered benchmark")
    p_bench.add_argument("--device", default="cuda",
                         help="cuda (default) or cpu")

    sub.add_parser("list-benchmarks", help="list registered benchmarks")

    args = parser.parse_args(argv)

    if args.cmd == "version":
        from tiberate_tpu_torch import __version__

        print(__version__)
        return 0

    if args.cmd == "list-benchmarks":
        from tiberate_tpu_torch.extension.benchmarks import benchreg

        for name, cls in sorted(benchreg.items()):
            print(f"{name:24s} {cls.description}")
        return 0

    if args.cmd == "benchmark":
        from tiberate_tpu_torch.extension.benchmarks import benchreg

        if args.all:
            names = sorted(benchreg)
        elif args.name:
            if args.name not in benchreg:
                print(f"unknown benchmark {args.name!r}; available: "
                      f"{sorted(benchreg)}", file=sys.stderr)
                return 2
            names = [args.name]
        else:
            # interactive: the curses selector on a TTY, a prompt elsewhere
            if sys.stdout.isatty() and sys.stdin.isatty():
                from tiberate_tpu_torch.extension.benchmarks.selector import (
                    run_selector,
                )

                res = run_selector(iters=args.iters, device=args.device)
                if res is not None and args.file:
                    with open(args.file, "w") as f:
                        json.dump([res.to_json()], f, indent=2)
                    print(f"results written to {args.file}")
                return 0
            names = sorted(benchreg)
            print("Available benchmarks:")
            for i, n in enumerate(names):
                print(f"  [{i}] {n:24s} {benchreg[n].description}")
            sel = input("Run which (index, name, or 'all')? ").strip()
            if sel != "all":
                names = [names[int(sel)] if sel.isdigit() else sel]

        results = []
        for name in names:
            from tiberate_tpu_torch.extension.benchmarks.vis import (
                visualize_benchmark_result,
            )

            bench = benchreg[name]()
            res = bench.run(preset=args.preset, iters=args.iters,
                            device=args.device)
            visualize_benchmark_result(res)
            results.append(res.to_json())

        if args.file:
            with open(args.file, "w") as f:
                json.dump(results, f, indent=2)
            print(f"results written to {args.file}")
        return 0

    parser.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
