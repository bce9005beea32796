"""Terminal rendering of benchmark results.

The torch counterpart of ``tiberate_tpu/extension/benchmarks/vis.py``:
``rich`` tables where ``rich`` is installed, plain text where it is not,
and a self-contained braille line plot for series metrics; every metric
kind renders, over a pipe too.
"""

from __future__ import annotations

from tiberate_tpu_torch.extension.benchmarks.interface import (
    BenchmarkResult,
    Metric,
    MetricKind,
)

try:
    from rich.console import Console
    from rich.table import Table

    _console = Console()
except ImportError:  # plain text without rich
    _console = None


# ----------------------------------------------------------------------
# Braille line plot.
# ----------------------------------------------------------------------

# Braille cell = 2x4 dot grid; unicode offset per dot position:
_BRAILLE_DOT = [
    [0x01, 0x08],
    [0x02, 0x10],
    [0x04, 0x20],
    [0x40, 0x80],
]


def render_line_plot(xs, ys, *, width: int = 64, height: int = 12,
                     title: str = "", unit: str = "") -> str:
    """ASCII/braille line plot of y(x); returns a multi-line string.

    ``width``/``height`` are in character cells (each cell holds 2x4
    braille dots, so the drawing grid is 2*width x 4*height).
    """
    xs = [float(v) for v in xs]
    ys = [float(v) for v in ys]
    if not xs or len(xs) != len(ys):
        return f"{title}: (no data)"
    gw, gh = 2 * width, 4 * height
    xmin, xmax = min(xs), max(xs)
    ymin, ymax = min(ys), max(ys)
    xspan = (xmax - xmin) or 1.0
    yspan = (ymax - ymin) or 1.0

    def to_grid(x, y):
        gx = int((x - xmin) / xspan * (gw - 1))
        gy = int((y - ymin) / yspan * (gh - 1))
        return gx, (gh - 1) - gy  # y grows downward on screen

    cells = [[0] * width for _ in range(height)]

    def set_dot(gx, gy):
        if 0 <= gx < gw and 0 <= gy < gh:
            cells[gy // 4][gx // 2] |= _BRAILLE_DOT[gy % 4][gx % 2]

    # Sort by x and draw line segments with simple DDA interpolation.
    pts = sorted(zip(xs, ys))
    prev = None
    for x, y in pts:
        gx, gy = to_grid(x, y)
        if prev is not None:
            px, py = prev
            steps = max(abs(gx - px), abs(gy - py), 1)
            for s in range(steps + 1):
                set_dot(px + (gx - px) * s // steps,
                        py + (gy - py) * s // steps)
        else:
            set_dot(gx, gy)
        prev = (gx, gy)

    lab_w = 10
    lines = []
    if title:
        lines.append(f"{'':{lab_w}} {title}" + (f" [{unit}]" if unit else ""))
    for r, row in enumerate(cells):
        if r == 0:
            lab = f"{ymax:.4g}"
        elif r == height - 1:
            lab = f"{ymin:.4g}"
        else:
            lab = ""
        body = "".join(chr(0x2800 + c) for c in row)
        lines.append(f"{lab:>{lab_w}} |{body}")
    x_axis = f"{'':{lab_w}} +" + "-" * width
    lines.append(x_axis)
    lines.append(f"{'':{lab_w}}  {xmin:<.6g}{'':{max(1, width - 24)}}"
                 f"{xmax:>.6g}")
    return "\n".join(lines)


# ----------------------------------------------------------------------
# Per-kind renderers.
# ----------------------------------------------------------------------


def _vis_scalars(metrics: list[Metric]) -> None:
    if not metrics:
        return
    if _console is not None:
        table = Table(title="Scalar metrics")
        table.add_column("Name")
        table.add_column("Value", justify="right")
        table.add_column("Unit")
        for m in metrics:
            v = m.value
            table.add_row(m.name,
                          f"{v:.6g}" if isinstance(v, float) else str(v),
                          m.unit)
        _console.print(table)
    else:
        for m in metrics:
            print(f"  {m.name}: {m.value} {m.unit}")


def _vis_series(metrics: list[Metric]) -> None:
    for m in metrics:
        print(render_line_plot(m.value["x"], m.value["y"],
                               title=m.name, unit=m.unit))


def _vis_tables(metrics: list[Metric]) -> None:
    for m in metrics:
        if _console is not None:
            table = Table(title=m.name)
            for col in m.value["columns"]:
                table.add_column(str(col))
            for row in m.value["rows"]:
                table.add_row(*[str(x) for x in row])
            _console.print(table)
        else:
            print(f"  {m.name}:")
            print("    " + " | ".join(map(str, m.value["columns"])))
            for row in m.value["rows"]:
                print("    " + " | ".join(map(str, row)))


def _vis_distributions(metrics: list[Metric]) -> None:
    if not metrics:
        return
    if _console is not None:
        table = Table(title="Distributions")
        for col in ("Name", "mean", "std", "min", "max", "n", "unit"):
            table.add_column(col, justify="right" if col != "Name" else "left")
        for m in metrics:
            d = m.value
            table.add_row(m.name, f"{d['mean']:.4g}", f"{d['std']:.4g}",
                          f"{d['min']:.4g}", f"{d['max']:.4g}",
                          str(d["n"]), m.unit)
        _console.print(table)
    else:
        for m in metrics:
            d = m.value
            print(f"  {m.name}: mean={d['mean']:.4g} std={d['std']:.4g}")


def visualize_benchmark_result(result: BenchmarkResult) -> None:
    """Render one result: tables (rich or plain text) and braille plots."""
    header = f"=== {result.name} ==="
    if _console is not None:
        _console.print(header, style="bold")
    else:
        print(header)
    if result.notes:
        print(result.notes)
    by_kind = {k: [] for k in MetricKind}
    for m in result.metrics:
        by_kind[m.kind].append(m)
    _vis_scalars(by_kind[MetricKind.SCALAR])
    _vis_tables(by_kind[MetricKind.TABLE])
    _vis_series(by_kind[MetricKind.SERIES])
    _vis_distributions(by_kind[MetricKind.DISTRIBUTION])
