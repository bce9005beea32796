"""The CLI, the benchmark registry and its renderers, and the tracing
helpers of tiberate_tpu_torch, on the CPU.

* ``python -m tiberate_tpu_torch version`` / ``list-benchmarks`` in a
  subprocess with ``jax`` made unimportable;
* the registry's names and descriptions are the JAX package's;
  ``BenchmarkResult``'s json is the JAX package's for the same metrics;
* ``benchmark --name single_pmult --preset toy --device cpu --file F`` in
  process writes the result's json; an unknown name exits 2; the default
  device is the card, so without one the run raises;
* the selector's state machine moves as the JAX package's on the same
  keys, and the selector refuses to run without a TTY;
* ``vis`` renders every metric kind, with ``rich`` and without it;
* ``trace.profile`` writes a chrome trace holding the ``annotate`` names
  of an engine op.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX_CLI = """
import runpy, sys
sys.modules["jax"] = None          # any import of jax now fails
sys.argv = ["tiberate_tpu_torch", {cmd!r}]
try:
    runpy.run_module("tiberate_tpu_torch", run_name="__main__")
finally:
    assert "tiberate_tpu" not in sys.modules
"""


@pytest.mark.parametrize("cmd", ["version", "list-benchmarks"])
def test_cli_runs_without_jax(cmd):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_CLI.format(cmd=cmd)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    if cmd == "version":
        from tiberate_tpu_torch import __version__

        assert proc.stdout.strip() == __version__
    else:
        names = [line.split()[0] for line in proc.stdout.splitlines()]
        assert names == sorted(["single_cmult", "single_pmult",
                                "lat_of_each_level", "linear_feature_wise",
                                "batched_inference"])


def test_registry_matches_jax():
    from tiberate_tpu.extension.benchmarks import benchreg as jreg
    from tiberate_tpu_torch.extension.benchmarks import benchreg as treg

    assert sorted(treg) == sorted(jreg)
    for name, cls in treg.items():
        assert cls.name == name
        assert cls.description == jreg[name].description


def _filled(mod):
    res = mod.BenchmarkResult(name="t", notes="n")
    res.add_scalar("a", 1.5, "ms")
    res.add_series("s", [0, 1], [2.0, 3.0])
    res.add_table("t", ["x", "y"], [[1, 2]])
    res.add_distribution("d", [1, 2, 3])
    return res


def test_benchmark_result_json_matches_jax(capsys):
    from tiberate_tpu.extension import benchmarks as jbench
    from tiberate_tpu_torch.extension import benchmarks as tbench

    tj, jj = _filled(tbench).to_json(), _filled(jbench).to_json()
    tj.pop("started_at"), jj.pop("started_at")
    assert tj == jj and len(tj["metrics"]) == 4
    assert json.loads(_filled(tbench).dumps())["metrics"] == tj["metrics"]
    _filled(tbench).print_terminal()
    out = capsys.readouterr().out
    assert "=== t ===" in out and "mean=2" in out


def test_cli_benchmark_in_process(tmp_path, capsys):
    from tiberate_tpu_torch._cli import main

    path = str(tmp_path / "res.json")
    assert main(["benchmark", "--name", "single_pmult", "--preset", "toy",
                 "--iters", "1", "--device", "cpu", "--file", path]) == 0
    with open(path) as f:
        results = json.load(f)
    assert [r["name"] for r in results] == ["single_pmult[toy]"]
    vals = {m["name"]: m["value"] for m in results[0]["metrics"]}
    assert set(vals) == {"pc_mult", "decrypt_max_err", "pt_cache_size_mb"}
    assert vals["decrypt_max_err"] < 5e-5 and vals["pc_mult"] > 0
    assert main(["benchmark", "--name", "nope", "--device", "cpu"]) == 2
    assert "unknown benchmark" in capsys.readouterr().err
    assert main([]) == 1


def test_cli_benchmark_needs_a_card_by_default():
    import torch

    from tiberate_tpu_torch._cli import main

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["benchmark", "--name", "single_pmult", "--preset", "toy",
              "--iters", "1"])


def test_selector_state_machine_matches_jax():
    from tiberate_tpu.extension.benchmarks import selector as jsel
    from tiberate_tpu_torch.extension.benchmarks import selector as tsel

    assert tsel.DEFAULT_OPTIONS == jsel.DEFAULT_OPTIONS
    jst, tst = jsel.SelectorState(), tsel.SelectorState()
    assert tst.bench_names == jst.bench_names
    n_bench = len(tst.bench_names)
    keys = (["DOWN"] * (n_bench + 1) + ["RIGHT", "DOWN", "DOWN", "UP",
                                        "LEFT", "DOWN", "RIGHT", "UP", "x"])
    for key in keys:
        assert tst.handle_key(key) == jst.handle_key(key), key
        state = (tst.bench_idx, tst.option_idx, tst.focus,
                 tst.current_option, tst.option_description,
                 tst.bench_description)
        assert state == (jst.bench_idx, jst.option_idx, jst.focus,
                         jst.current_option, jst.option_description,
                         jst.bench_description), key
    for key, action in (("ENTER", "run"), ("^R", "run"), ("r", "run"),
                        ("q", "quit"), ("^Q", "quit"), ("UP", None)):
        assert tst.handle_key(key) == action


def test_selector_requires_tty():
    from tiberate_tpu_torch.extension.benchmarks.selector import run_selector

    with pytest.raises(RuntimeError, match="TTY"):
        run_selector(device="cpu")  # pytest captures stdout: not a TTY


@pytest.mark.parametrize("with_rich", [True, False])
def test_vis_renders_all_metric_kinds(capsys, monkeypatch, with_rich):
    from tiberate_tpu_torch.extension import benchmarks as tbench
    from tiberate_tpu_torch.extension.benchmarks import vis

    if not with_rich:
        monkeypatch.setattr(vis, "_console", None)
    res = tbench.BenchmarkResult(name="vis-test")
    res.add_scalar("lat", 1.25, "ms")
    res.add_series("levels", list(range(8)), [2.0 ** i for i in range(8)],
                   "ms")
    res.add_table("ops", ["op", "ms"], [["mult", 1.2], ["rot", 3.4]])
    res.add_distribution("err", [1e-8, 2e-8, 3e-8])
    vis.visualize_benchmark_result(res)
    out = capsys.readouterr().out
    for word in ("vis-test", "lat", "levels", "mult", "rot", "err"):
        assert word in out, word
    plot = vis.render_line_plot([0, 1, 2], [0.0, 1.0, 0.5], width=20,
                                height=5, title="p")
    assert any(ch >= "⠀" for ch in plot) and "p" in plot
    assert "(no data)" in vis.render_line_plot([], [], title="empty")


def test_trace_profile_writes_annotated_trace(tmp_path):
    """``profile`` around an engine op with ``annotate`` ranges writes a
    chrome trace (json) holding the range names."""
    from tiberate_tpu_torch.config.toy import toy_config
    from tiberate_tpu_torch.engine import CkksEngine
    from tiberate_tpu_torch.utils import trace

    eng = CkksEngine(toy_config(logN=6, num_scales=3, num_special_primes=1),
                     device="cpu", seed=2)
    ct = eng.encodecrypt(np.linspace(-1, 1, eng.num_slots))
    rotk = eng.get_rotation_key(1)
    with trace.profile(str(tmp_path)) as path:
        with trace.annotate("tt_rotate"):
            eng.rotate_single(ct, rotk)
        with trace.annotate("tt_decrypt"):
            eng.decryptcode(ct)
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"tt_rotate", "tt_decrypt"} <= names
