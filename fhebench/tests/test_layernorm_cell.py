"""The LayerNorm cell (``logN15-layernorm768``) at a toy ring on the CPU:
its files and entries are all it needs; it reads correct, names its idle
gaps by its own spans and has its program launches read from the
``layernorm`` root; each fault it can have, planted once the window
opens, reads as not correct; its readers read the program's spans.

The toy: the real configuration's deployment with 8 features on a chain
of 16 levels (logN 7), deep enough for the circuit's 15 rescales."""

import json
import os
import shutil
import types

import pytest
from tiberate_tpu_torch.extension import nn as tnn
from tiberate_tpu_torch.utils import trace

from fhebench import harness, layer_spans, program
from fhebench import spans as spanlib
from fhebench.tests import toy
from fhebench.tests.test_harness import tree_hashes

CELL = "logN15-layernorm768"
CONFIG = "bert-base-layernorm-logN15"
SEED = 2**33 + 7
# the toy's own limits: its scale is 2^30, not the preset's 2^40
LIMITS = {"residues": 0, "fresh": 1e-6, "layernorm": 1e-4, "approx": 1e-2,
          "key_noise": 31}
# the cell's files, relative to the checkout
FILES = ["fhebench/ops/layernorm.py", "fhebench/reference/layernorm.py",
         "fhebench/roofline/layernorm.py", "fhebench/layer_spans.py",
         "fhebench/configs/bert-base-layernorm-logN15.json",
         "fhebench/traffic/layernorm768.json",
         "fhebench/metrics/kernels_roofline.layernorm.py",
         "fhebench/metrics/device_idle_pct.layernorm.py",
         "fhebench/metrics/launches_per_forward.layernorm.py",
         "fhebench/metrics/newton_ms.layernorm.py"]


def quiet(msg):
    pass


def toy_config():
    with open(os.path.join(toy.ROOT, "fhebench", "configs",
                           f"{CONFIG}.json")) as f:
        real = json.load(f)
    cfg = toy.toy_config(CONFIG, dict(logN=7, num_scales=16,
                                      num_special_primes=2, scale_bits=30),
                         LIMITS)
    cfg["deployment"] = dict(real["deployment"], hidden_size=8)
    return cfg


def make_root(tmp):
    """A toy checkout holding the cell; one traced request, so that the
    CPU window's single gap has its middle in the request."""
    root, bench = toy.make_root(tmp, {CONFIG: toy_config()}, client=False)
    mix = os.path.join(root, "fhebench/traffic/layernorm768.json")
    with open(mix) as f:
        m = json.load(f)
    toy.write(root, "fhebench/traffic/layernorm768.json",
              dict(m, profile_requests=1))
    return root, bench


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("ln"))[0]


def test_cell_is_files_and_entries(tmp_path):
    """Without the cell's files and entries the checkout lacks the cell;
    adding them back changes no file that was there but BENCHMARK.json,
    and the cell runs correct."""
    root, bench = make_root(tmp_path)
    kept = {rel: open(os.path.join(root, rel), "rb").read() for rel in FILES}
    for rel in FILES:
        os.remove(os.path.join(root, rel))
    without = json.loads(json.dumps(bench))
    without["configs"] = [c for c in bench["configs"] if c["name"] != CONFIG]
    without["workloads"] = [w for w in bench["workloads"]
                            if w["name"] != CELL]
    for m in without["end_to_end"] + without["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].remove(CELL)
    without["per_layer"] = [m for m in without["per_layer"]
                            if m.get("workloads", [None])]
    toy.write(root, "BENCHMARK.json", without)
    with pytest.raises(KeyError):
        harness.Bench(root).cell(CELL)
    shutil.rmtree(os.path.join(root, "fhebench", "__pycache__"),
                  ignore_errors=True)
    made = tree_hashes(root)
    for rel, data in kept.items():
        with open(os.path.join(root, rel), "wb") as f:
            f.write(data)
    toy.write(root, "BENCHMARK.json", bench)
    now = tree_hashes(root)
    assert {p for p in made if now.get(p) != made[p]} == {"BENCHMARK.json"}
    assert set(now) - set(made) == set(FILES)
    res, checks = harness.run_cell(root, CELL, SEED, 0.05, False, "cpu",
                                   log=quiet)
    assert res["correct"], checks


def test_cell_runs_correct(root):
    res, checks = harness.run_cell(root, CELL, SEED, 0.05, False, "cpu",
                                   log=quiet)
    assert res["correct"], checks
    assert set(res["metrics"]) == {"hmult_per_s.logN15", "setup_s"}
    assert {n for n, _, _ in checks} == {
        "residue_mismatch", "layernorm_err", "approx_err", "input_err",
        "sk_mismatch", "evk_noise"}
    # 2 F + 3 iters a forward
    assert res["metrics"]["hmult_per_s.logN15"]["value"] > 0
    res, checks = harness.run_cell(root, CELL, SEED, 0.05, True, "cpu",
                                   log=quiet)
    assert res["correct"], checks
    # no card: the traced window is one idle gap, its middle in the forward
    assert [n for n, _ in res["breakdown"]["idle_gaps"]] == ["layernorm"]
    assert res["metrics"] == {}   # no kernels in the trace: nothing to read


def at_window(monkeypatch, owner, method, wrap):
    """Break ``owner.<method>`` once the window opens, after the
    operation's own ``start_window``."""
    orig = getattr(owner, method)
    find = harness.Bench.op

    def op(bench, name):
        class Broken(find(bench, name)):
            def start_window(self):
                super().start_window()
                monkeypatch.setattr(owner, method, wrap(orig))
        return Broken

    monkeypatch.setattr(harness.Bench, "op", op)


def altered(orig):
    def forward(self, x, **kwargs):
        out = orig(self, x, **kwargs)
        d = out.data[1]
        d[5, 0, 3] = (d[5, 0, 3] + 1) % self.engine.params.q[out.level]
        return out
    return forward


def two_steps(orig):
    def forward(self, x, **kwargs):
        self.iters = 2
        return orig(self, x, **kwargs)
    return forward


def half_stack(orig):
    def forward(self, x, **kwargs):
        out = orig(self, x, **kwargs)
        n = out.data[0].shape[0] // 2
        return type(out)(data=tuple(d[:n] for d in out.data),
                         level=out.level, **out.misc)
    return forward


def feature_left_out(orig):
    """The mean's sum over the level-0 input misses its last feature."""
    def tree_sum(engine, ct):
        if ct.level == 0:
            ct = tnn._rows(ct, 0, ct.data[0].shape[0] - 1)
        return orig(engine, ct)
    return tree_sum


FAULTS = {
    "one_residue": (tnn.HELayerNormFeatureWise, "forward", altered),
    "two_newton_steps": (tnn.HELayerNormFeatureWise, "forward", two_steps),
    "half_the_stack": (tnn.HELayerNormFeatureWise, "forward", half_stack),
    "feature_left_out_of_mean": (tnn, "tree_sum", feature_left_out),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_reads_not_correct(root, monkeypatch, fault):
    owner, method, wrap = FAULTS[fault]
    at_window(monkeypatch, owner, method, wrap)
    res, checks = harness.run_cell(root, CELL, SEED, 0.05, False, "cpu",
                                   log=quiet)
    assert not res["correct"], checks
    bad = {n for n, v, lim in checks
           if not isinstance(v, (int, float)) or v > lim}
    assert "residue_mismatch" in bad, checks


def test_control_reads_not_correct(tmp_path):
    """The program's 30-bit lane in its place, held to the 62-bit
    limits."""
    cfg = toy.toy_config(CONFIG, toy.TOY30 | dict(num_scales=16), LIMITS)
    cfg["deployment"] = toy_config()["deployment"]
    root, _ = toy.make_root(tmp_path, {CONFIG: cfg}, client=False)
    res, checks = harness.run_cell(root, CELL, SEED, 0.05, False, "cpu",
                                   log=quiet)
    assert not res["correct"], checks


def test_readers_read_the_program_spans(root):
    """The cell's readers on a run whose trace holds kernels (a stand-in
    for the card's) and the program's span records of one forward: the
    Newton chain's span, the chunks for the roofline, the launches, and
    torch's launches counted from the ``layernorm`` root."""
    bench = harness.Bench(root)
    cfg = bench.config(CONFIG)
    op = bench.op("layernorm")(cfg, bench.mix("layernorm768"), SEED, "cpu")
    op.setup()
    trace.clear()
    sp = spanlib.Spans()
    with trace.profile():
        sp.begin()
        sp.end(op.request(sp))
    run = harness.Run(bench.cell(CELL), cfg, bench.mix("layernorm768"))
    run.requests = [types.SimpleNamespace(t1=-1.0)]
    launches = sum(r.launches for r in trace.spans() if r.parent is None)
    run.trace = types.SimpleNamespace(requests=1, kernels=launches + 40,
                                      kernel_s=2.0, busy_s=1.5, window_s=2.0)
    run.sm_clock_hz = 1.98e9
    read = {m: bench.reader(m)(run) for m in (
        "newton_ms.layernorm", "kernels_roofline.layernorm",
        "launches_per_forward.layernorm", "device_idle_pct.layernorm")}
    assert [r.name for r in program.roots(run)] == ["layernorm"]
    assert program.torch_launches(run, 1) == 40
    chunks = layer_spans.inside(run, "layernorm", "cc_mult",
                                "layernorm.square")
    assert [len(c) for c in chunks] == [1]      # 8 features, one chunk
    assert read["newton_ms.layernorm"] > 0
    assert 0 < read["kernels_roofline.layernorm"] < 100
    assert read["launches_per_forward.layernorm"] == launches + 40
    assert read["device_idle_pct.layernorm"] == pytest.approx(25.0)
    op.release()
    trace.clear()

