"""The feed-forward cell (``logN15-ffn3072``) at a toy ring on the CPU: its
files and entries are all it needs; it reads correct, names its idle gap
by its own span; each fault it can have, planted once the window opens,
reads as not correct; the 30-bit control does; its readers read the
program's spans and the trace's kernels.

The toy: the real configuration's deployment with 8 hidden and 32
intermediate features on a chain of 6 levels (logN 7), deeper than the
circuit's 3 rescales."""

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

CELL = "logN15-ffn3072"
CONFIG = "bert-base-ffn-logN15"
MIX = "ffn3072"
SEED = 2**33 + 9
# the toy's own limits: its scale is 2^30, not the preset's 2^40
LIMITS = {"residues": 0, "fresh": 1e-6, "ffn": 1e-5, "key_noise": 31}
TOY = dict(logN=7, num_scales=6, num_special_primes=2, scale_bits=30)
# the cell's files, relative to the checkout
FILES = ["fhebench/ops/ffn.py", "fhebench/reference/ffn.py",
         "fhebench/roofline/ffn.py",
         "fhebench/configs/bert-base-ffn-logN15.json",
         "fhebench/traffic/ffn3072.json",
         "fhebench/metrics/kernels_roofline.ffn.py",
         "fhebench/metrics/matmul_roofline.ffn.py",
         "fhebench/metrics/device_idle_pct.ffn.py",
         "fhebench/metrics/launches_per_forward.ffn.py"]
METRICS = ("kernels_roofline.ffn", "matmul_roofline.ffn",
           "device_idle_pct.ffn", "launches_per_forward.ffn")


def quiet(msg):
    pass


def deployment():
    with open(os.path.join(toy.ROOT, "fhebench", "configs",
                           f"{CONFIG}.json")) as f:
        real = json.load(f)
    return dict(real["deployment"], hidden_size=8, intermediate_size=32)


def toy_config(opts=TOY):
    cfg = toy.toy_config(CONFIG, opts, LIMITS)
    cfg["deployment"] = deployment()
    return cfg


def make_root(tmp, cfg=None):
    """A toy checkout holding the cell; one traced request, so that the
    CPU window's single gap has its middle in the request."""
    root, bench = toy.make_root(tmp, {CONFIG: cfg or toy_config()},
                                client=False)
    path = os.path.join(root, "fhebench", "traffic", f"{MIX}.json")
    with open(path) as f:
        m = json.load(f)
    toy.write(root, f"fhebench/traffic/{MIX}.json",
              dict(m, profile_requests=1))
    return root, bench


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("ffn"))[0]


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


def test_entries_of_the_real_benchmark():
    """In the repository's BENCHMARK.json: the cell on one chip, reporting
    ``hmult_per_s.logN15``, ``peak_mem_gib`` and ``setup_s`` untraced and
    its four per-layer metrics traced, each listing the cell alone."""
    bench = harness.Bench(toy.ROOT)
    assert bench.cell(CELL) == {
        "name": CELL, "config": CONFIG, "traffic": MIX, "chips": 1,
        "why": bench.cell(CELL)["why"]}
    assert {m["name"] for m in bench.metrics(CELL, False)} == {
        "hmult_per_s.logN15", "peak_mem_gib", "setup_s"}
    layer = {m["name"]: m for m in bench.metrics(CELL, True)}
    assert set(layer) == set(METRICS)
    for m in layer.values():
        assert m["workloads"] == [CELL]
        assert m["moves"] == "hmult_per_s.logN15"
    cfg = bench.config(CONFIG)
    assert cfg["limits"]["residues"] == 0
    assert set(cfg["limits"]) == {"residues", "fresh", "ffn", "key_noise"}


def test_cell_runs_correct(root):
    res, checks = harness.run_cell(root, CELL, SEED, 0.05, False, "cpu",
                                   log=quiet)
    assert res["correct"], checks
    assert set(res["metrics"]) == {"hmult_per_s.logN15", "setup_s"}
    assert {n for n, _, _ in checks} == {
        "residue_mismatch", "ffn_err", "input_err", "sk_mismatch",
        "evk_noise"}
    assert res["metrics"]["hmult_per_s.logN15"]["value"] > 0
    res, checks = harness.run_cell(root, CELL, SEED, 0.05, True, "cpu",
                                   log=quiet)
    assert res["correct"], checks
    # no card: the traced window is one idle gap, its middle in the forward
    assert [n for n, _ in res["breakdown"]["idle_gaps"]] == ["ffn"]
    assert res["metrics"] == {}   # no kernels in the trace: nothing to read


def at_window(monkeypatch, owner, method, wrap):
    """Break ``owner.<method>`` once the window opens."""
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


def gelu_constant(orig):
    """Quad's constant left out of the activation."""
    def forward(self, x, **kwargs):
        self.c0 = 0.0
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
    """Each weighted sum misses its last input feature."""
    def matrix_sum(self, ct, weights, acc=None):
        n = ct.data[0].shape[0] - 1
        limbs = weights.limbs[:, :n].contiguous()
        return orig(self, tnn._rows(ct, 0, n), weights._replace(limbs=limbs),
                    acc)
    return matrix_sum


FAULTS = {
    "one_residue": (tnn.HEFeedForwardFeatureWise, "forward", altered),
    "no_constant": (tnn.HEFeedForwardFeatureWise, "forward", gelu_constant),
    "half_the_stack": (tnn.HEFeedForwardFeatureWise, "forward", half_stack),
    "feature_left_out": (harness.generator.CkksEngine, "_matrix_sum",
                         feature_left_out),
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


def test_a_small_block_reads_correct(root, monkeypatch):
    """Blocks of 5 intermediate features: the same residues."""
    monkeypatch.setattr(tnn, "ffn_block", lambda engine, level: 5)
    res, checks = harness.run_cell(root, CELL, SEED, 0.05, False, "cpu",
                                   log=quiet)
    assert res["correct"], checks


def test_control_reads_not_correct(tmp_path):
    """The program's 30-bit lane in its place, held to the 62-bit
    limits."""
    root, _ = make_root(tmp_path, toy_config(toy.TOY30 | dict(num_scales=6)))
    res, checks = harness.run_cell(root, CELL, SEED, 0.05, False, "cpu",
                                   log=quiet)
    assert not res["correct"], checks


def test_parent_fails_at_once(root, monkeypatch):
    """A program without ``CkksEngine.feed_forward`` (the commit before
    the cell) fails in set-up, before any window."""
    monkeypatch.delattr(harness.generator.CkksEngine, "feed_forward")
    with pytest.raises(RuntimeError, match="feed_forward"):
        harness.run_cell(root, CELL, SEED, 0.05, False, "cpu", log=quiet)


def test_readers_read_the_program_spans(root):
    """The cell's readers on a run whose trace holds kernels (a stand-in
    for the card's, the matrix product's among them) and the program's
    span records of one forward: the square chunks for the roofline, the
    launches, the idle share; without the product's kernel its share
    reads nothing."""
    bench = harness.Bench(root)
    cfg = bench.config(CONFIG)
    op = bench.op("ffn")(cfg, bench.mix(MIX), SEED, "cpu")
    op.setup()
    trace.clear()
    sp = spanlib.Spans()
    with trace.profile():
        sp.begin()
        sp.end(op.request(sp))
    run = harness.Run(bench.cell(CELL), cfg, bench.mix(MIX))
    run.requests = [types.SimpleNamespace(t1=-1.0)]
    launches = sum(r.launches for r in trace.spans() if r.parent is None)
    run.trace = types.SimpleNamespace(
        requests=1, kernels=launches + 40, kernel_s=2.0, busy_s=1.5,
        window_s=2.0, device_ops=[("matmul_k<long long, 2>", 1.2),
                                  ("parts_contig_k<long long, 7>", 0.3)])
    run.sm_clock_hz = 1.98e9
    read = {m: bench.reader(m)(run) for m in METRICS}
    assert [r.name for r in program.roots(run)] == ["ffn"]
    assert program.torch_launches(run, 1) == 40
    chunks = layer_spans.inside(run, "ffn", "cc_mult", "ffn.act")
    assert [len(c) for c in chunks] == [1]      # 32 features, one chunk
    assert 0 < read["kernels_roofline.ffn"] < 100
    assert 0 < read["matmul_roofline.ffn"] < 100
    assert read["launches_per_forward.ffn"] == launches + 40
    assert read["device_idle_pct.ffn"] == pytest.approx(25.0)
    run.trace.device_ops = [("parts_contig_k<long long, 7>", 0.3)]
    assert bench.reader("matmul_roofline.ffn")(run) is None
    op.release()
    trace.clear()
