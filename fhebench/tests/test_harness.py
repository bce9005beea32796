"""The harness end to end at a toy ring on the CPU (the chip's look
skipped): every cell correct; a cell, configuration, mix and metric
added as files only; each fault the cells can have, planted under the
timed path, and the control, all read as not correct."""

import json
import os
import subprocess
import sys

import pytest
import torch
from tiberate_tpu_torch.engine import ckks_engine

from fhebench import generator, harness
from fhebench.tests import toy

CELLS = ["logN17-mult8", "logN15-mult8", "logN15-rotsum8", "logN15-client8"]
SEED = 2**33 + 3


def quiet(msg):
    pass


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.make_root(tmp_path_factory.mktemp("bench"))[0]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_correct(root, cell, traced):
    res, checks = harness.run_cell(root, cell, SEED, 0.05, traced, "cpu",
                                   log=quiet)
    assert res["correct"], checks
    assert res["attempted"] >= 1
    names = set(res["metrics"])
    if traced:   # no card: the trace readers find nothing to read
        assert names <= {"encrypt_ms.client", "decrypt_ms.client"}
    else:
        assert "setup_s" in names and len(names) == 2
    assert list(res)[-1] == "checks"


def test_added_as_files_only(tmp_path):
    root, bench = toy.make_root(tmp_path)
    toy.write(root, "fhebench/configs/toy-extra.json",
              toy.toy_config("toy-extra", dict(toy.TOY, logN=6)))
    toy.write(root, "fhebench/traffic/mult2.json",
              {"op": "cc_mult", "batch": 2, "level": 0, "warmup": 1,
               "profile_warmup": 1, "profile_requests": 2})
    with open(os.path.join(root, "fhebench/metrics/requests_per_s.extra.py"),
              "w") as f:
        f.write("def read(run):\n"
                "    return len(run.requests) / run.window_s\n")
    bench["configs"].append({"name": "toy-extra", "source": "a test",
                             "file": "fhebench/configs/toy-extra.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy-extra-mult2",
                               "config": "toy-extra", "traffic": "mult2",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "hmult_per_s":
            m["workloads"].append("toy-extra-mult2")
    bench["per_layer"].append({
        "name": "requests_per_s.extra", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "Engine API, fused step",
        "moves": "hmult_per_s", "workloads": ["toy-extra-mult2"]})
    toy.write(root, "BENCHMARK.json", bench)
    res, _ = harness.run_cell(root, "toy-extra-mult2", SEED, 0.05, False,
                              "cpu", log=quiet)
    assert res["correct"] and "hmult_per_s" in res["metrics"]
    res, _ = harness.run_cell(root, "toy-extra-mult2", SEED, 0.05, True,
                              "cpu", log=quiet)
    assert res["correct"] and res["metrics"]["requests_per_s.extra"][
        "value"] > 0


def test_reader_falls_back_to_shorter_name(tmp_path):
    root, _ = toy.make_root(tmp_path, client=False)
    with open(os.path.join(root, "fhebench/metrics/hmult_per_s.other.py"),
              "w") as f:
        f.write("def read(run):\n    return 7\n")
    bench = harness.Bench(root)
    assert bench.reader("hmult_per_s.logN15").__module__ == (
        "fhebench_metric_hmult_per_s")
    assert bench.reader("hmult_per_s.other")(None) == 7
    assert bench.reader("hmult_per_s.other.logN16")(None) == 7
    with pytest.raises(FileNotFoundError):
        bench.reader("no_such_metric.logN15")

def at_window(monkeypatch, method, wrap):
    """Break ``CkksEngine.<method>`` once the window opens."""
    orig_start = generator.Op.start_window
    orig = getattr(ckks_engine.CkksEngine, method)

    def start(self):
        orig_start(self)
        monkeypatch.setattr(ckks_engine.CkksEngine, method, wrap(orig))

    for cls in generator.OPS.values():
        monkeypatch.setattr(cls, "start_window", start)


def unchanged(orig):
    def f(self, *args, **kwargs):
        return args[0]
    return f


def half_batch(orig):
    def f(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        for d in out.data:
            d[d.shape[0] // 2:] = 0
        return out
    return f


def altered(orig):
    def f(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        d = out.data[0]
        d[0, 0, 0] = (d[0, 0, 0] + 1) % self.params.q[out.level]
        return out
    return f


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell,method", [("logN17-mult8", "cc_mult"),
                                         ("logN15-rotsum8", "sum")])
def test_fault_reads_not_correct(root, monkeypatch, cell, method, fault):
    at_window(monkeypatch, method, FAULTS[fault])
    res, checks = harness.run_cell(root, cell, SEED, 0.05, False, "cpu",
                                   log=quiet)
    assert not res["correct"], checks


def client_unchanged(orig):
    first = []

    def f(self, ms, *args, **kwargs):
        if not first:
            first.append(orig(self, ms, *args, **kwargs))
        return first[0]
    return f


def client_half(orig):
    def f(self, ms, *args, **kwargs):
        ms = list(ms)
        h = len(ms) // 2
        return orig(self, ms[:h] + ms[:h], *args, **kwargs)
    return f


def client_altered(orig):
    def f(self, ms, *args, **kwargs):
        cts = orig(self, ms, *args, **kwargs)
        d = cts[0].data[0]
        d[1, 3] = (d[1, 3] + 1) % self.params.q[1]
        return cts
    return f


def decoded_altered(orig):
    def f(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        out[0, 0] += 1e-3
        return out
    return f


@pytest.mark.parametrize("method,wrap", [
    ("encodecrypt_batch", client_unchanged),
    ("encodecrypt_batch", client_half),
    ("encodecrypt_batch", client_altered),
    ("decryptcode_batch", decoded_altered)])
def test_client_fault_reads_not_correct(root, monkeypatch, method, wrap):
    at_window(monkeypatch, method, wrap)
    res, checks = harness.run_cell(root, "logN15-client8", SEED, 0.05, False,
                                   "cpu", log=quiet)
    assert not res["correct"], checks


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_not_correct(tmp_path, cell):
    """The program's 30-bit lane in its place, held to the 62-bit
    limits."""
    configs = {n: toy.toy_config(n, toy.TOY30)
               for n in ("ckks-logN17", "ckks-logN15")}
    root, _ = toy.make_root(tmp_path, configs)
    res, checks = harness.run_cell(root, cell, SEED, 0.05, False, "cpu",
                                   log=quiet)
    assert not res["correct"], checks
    errs = {n: v for n, v, _ in checks if n.endswith("_err")}
    assert max(errs.values()) > toy.LIMITS["mult"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(toy.ROOT, "fhebench", "run.py"),
         "--workload", "logN15-mult8", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, env=dict(os.environ,
                                                 CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_control_on_the_card():
    """The control at a cell's own size on three seeds (the card only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fhebench.tests import control

    res = control.readings(["logN15-mult8"], [5, 6, 7], 1.0, "cuda:0",
                           log=quiet)
    assert all(not ok for _, ok, _ in res["logN15-mult8"])
