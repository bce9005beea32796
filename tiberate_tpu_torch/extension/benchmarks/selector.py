"""Interactive terminal benchmark selector.

The torch counterpart of ``tiberate_tpu/extension/benchmarks/selector.py``:
a two-pane picker (benchmarks on the left, their options, the presets, on
the right) with descriptions under each pane, arrow keys to move and
switch panes, Enter / ctrl-r to run, q / ctrl-q to quit, on stdlib
``curses``.  The picked benchmark then runs and renders through
:mod:`tiberate_tpu_torch.extension.benchmarks.vis`.

The key and selection logic is :class:`SelectorState`, a state machine
with no terminal, so tests cover it without a TTY; :func:`run_selector`
refuses to run without one.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tiberate_tpu_torch.extension.benchmarks.interface import benchreg

#: Default option set: every benchmark here is parameterized by preset.
DEFAULT_OPTIONS = {
    "logN14": "production preset, N=2^14 (fast; ~7 levels)",
    "logN15": "production preset, N=2^15 (the reference's headline config)",
    "logN16": "production preset, N=2^16 (deep circuits; ~33 levels)",
    "toy": "toy ring logN8 (instant; CI-sized)",
}


def bench_options(cls) -> dict[str, str]:
    """Option name -> description for one benchmark class."""
    return dict(getattr(cls, "options", DEFAULT_OPTIONS))


@dataclass
class SelectorState:
    """Pure two-pane selection state.

    Panes: 0 = benchmark list, 1 = option list.  ``handle_key`` consumes
    one key name and returns ``"run"``, ``"quit"`` or ``None``.
    """

    benches: dict = field(default_factory=lambda: dict(benchreg))
    bench_idx: int = 0
    option_idx: int = 0
    focus: int = 0  # 0 = bench pane, 1 = option pane

    def __post_init__(self):
        self.bench_names = list(self.benches)

    # -- view helpers ---------------------------------------------------

    @property
    def current_bench(self):
        return self.benches[self.bench_names[self.bench_idx]]

    @property
    def current_options(self) -> dict[str, str]:
        return bench_options(self.current_bench)

    @property
    def current_option(self) -> str:
        names = list(self.current_options)
        return names[self.option_idx] if names else "default"

    @property
    def bench_description(self) -> str:
        return getattr(self.current_bench, "description", "")

    @property
    def option_description(self) -> str:
        return self.current_options.get(self.current_option, "")

    # -- transitions ----------------------------------------------------

    def handle_key(self, key: str):
        """key: curses key name ("UP", "DOWN", "LEFT", "RIGHT", "ENTER",
        "q", "r", ...): arrows move, left/right switch panes, Enter /
        ctrl-r runs, q / ctrl-q quits."""
        if key in ("q", "Q", "^Q"):
            return "quit"
        if key in ("ENTER", "^R", "r"):
            return "run"
        if key == "LEFT":
            self.focus = 0
        elif key == "RIGHT":
            self.focus = 1
            self.option_idx = min(
                self.option_idx, max(0, len(self.current_options) - 1))
        elif key in ("UP", "DOWN"):
            d = -1 if key == "UP" else 1
            if self.focus == 0:
                n = len(self.bench_names)
                self.bench_idx = (self.bench_idx + d) % n
                self.option_idx = 0  # a new benchmark starts at its first option
            else:
                n = max(1, len(self.current_options))
                self.option_idx = (self.option_idx + d) % n
        return None


# ----------------------------------------------------------------------
# curses front-end.
# ----------------------------------------------------------------------


def _key_name(ch) -> str:
    import curses

    table = {
        curses.KEY_UP: "UP", curses.KEY_DOWN: "DOWN",
        curses.KEY_LEFT: "LEFT", curses.KEY_RIGHT: "RIGHT",
        10: "ENTER", 13: "ENTER", curses.KEY_ENTER: "ENTER",
        17: "^Q", 18: "^R",
    }
    if ch in table:
        return table[ch]
    try:
        return chr(ch)
    except ValueError:
        return ""


def _draw(stdscr, state: SelectorState) -> None:
    import curses

    stdscr.erase()
    h, w = stdscr.getmaxyx()
    half = w // 2
    bold = curses.A_BOLD
    rev = curses.A_REVERSE

    stdscr.addnstr(0, 0, " tiberate_tpu_torch benchmarks ".center(w, "="), w - 1,
                   bold)
    foc = ("[benchmark pane]" if state.focus == 0 else "[option pane]")
    stdscr.addnstr(1, 0, f" arrows: move/switch pane   Enter/^R: run   "
                         f"q/^Q: quit   {foc}", w - 1)

    stdscr.addnstr(3, 1, "Select Benchmark", half - 2,
                   bold | (rev if state.focus == 0 else 0))
    stdscr.addnstr(3, half + 1, "Select Option", half - 2,
                   bold | (rev if state.focus == 1 else 0))

    for i, name in enumerate(state.bench_names):
        attr = rev if (i == state.bench_idx and state.focus == 0) else (
            bold if i == state.bench_idx else 0)
        stdscr.addnstr(5 + i, 2, name, half - 4, attr)
    for i, name in enumerate(state.current_options):
        attr = rev if (i == state.option_idx and state.focus == 1) else (
            bold if i == state.option_idx else 0)
        stdscr.addnstr(5 + i, half + 2, name, half - 4, attr)

    desc_row = max(6 + len(state.bench_names),
                   6 + len(state.current_options), h - 6)
    desc_row = min(desc_row, h - 5)
    stdscr.hline(desc_row - 1, 0, "-", w)
    stdscr.addnstr(desc_row, 1, state.bench_description, half - 2)
    stdscr.addnstr(desc_row, half + 1, state.option_description, half - 2)
    stdscr.refresh()


def _picker(stdscr, state: SelectorState):
    import curses

    curses.curs_set(0)
    stdscr.keypad(True)
    while True:
        _draw(stdscr, state)
        action = state.handle_key(_key_name(stdscr.getch()))
        if action == "quit":
            return None
        if action == "run":
            return state.current_bench, state.current_option


def run_selector(iters: int = 10, device: str = "cuda"):
    """Launch the picker; on selection, run the benchmark on ``device``
    and render it.  Returns the BenchmarkResult, or None if the user
    quit."""
    import curses
    import sys

    if not sys.stdout.isatty():
        raise RuntimeError(
            "benchmark selector needs a TTY; use --name/--all instead")

    state = SelectorState()
    picked = curses.wrapper(_picker, state)
    if picked is None:
        return None
    bench_cls, option = picked
    print(f"Running {bench_cls.name} [{option}] ...")
    result = bench_cls().run(preset=option, iters=iters, device=device)
    from tiberate_tpu_torch.extension.benchmarks.vis import (
        visualize_benchmark_result,
    )

    visualize_benchmark_result(result)
    return result
