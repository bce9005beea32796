"""The harness end to end at a toy ring on the CPU (the chip's look
skipped): every cell correct; a cell, configuration, mix and metric
added as files only; each fault the cells can have, planted under the
timed path, and the control, all read as not correct."""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch
from tiberate_tpu_torch.engine import ckks_engine

from fhebench import harness
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

# an operation of its own file: a batch squared three times, each
# product's residues held to the reference's chain, level by level
SQUARE3 = '''
from fhebench import generator
from fhebench.reference import ckks as ref

DEPTH = 3


class Square3(generator.Op):
    def setup(self):
        super().setup()
        self.keygen()
        self.m1 = generator.messages(self.rng, self.batch, self.slots)
        self.A = self.encrypt(self.m1)
        self.outs = None

    def request(self, spans):
        with spans.span("square3"):
            x, outs = self.A, []
            for _ in range(DEPTH):
                x = self.eng.cc_mult(x, x)
                outs.append(x)
        with spans.span("sync"):
            generator.sync(self.device)
        self.outs = outs
        return {"hmult": self.batch * DEPTH}

    def answers(self):
        return dict(A=self.A.data, outs=[x.data for x in self.outs],
                    sk=self.sk_rows(), evk=generator.key_rows(self.eng.evk))

    def check(self, pr, raw, limits):
        s, sk_bad = ref.secret(pr, raw["sk"])
        x, checks = raw["A"], []
        for i, out in enumerate(raw["outs"]):
            x = ref.cc_mult(pr, *x, *x, raw["evk"], self.level + i)
            checks.append((f"residue_mismatch.{i + 1}",
                           generator.compare(out, x), limits["residues"]))
        got = ref.decode(ref.decrypt(pr, *raw["outs"][0], s, self.level + 1,
                                     ref.mult_scale(pr, self.level))[0])
        return checks + [
            ("decrypt_err", generator.err(got, self.m1 ** 2),
             limits["mult"]),
            ("sk_mismatch", sk_bad, limits["residues"]),
        ]


OP = Square3
'''


def tree_hashes(root):
    """{path relative to ``root``: sha256} of every file under it."""
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


# an operation file a checkout may already hold
OTHER = """
from fhebench import generator

OP = generator.CcMult
"""


def add_file(root, rel, text):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def add_square3(tmp_path, others):
    """A toy checkout, with the operation files ``others`` ({name: source})
    among its own, to which the ``square3`` operation, its mix and its
    cell are added as files and entries; (root, hashes before they
    are)."""
    root, bench = toy.make_root(tmp_path, client=False)
    for name, text in others.items():
        add_file(root, f"fhebench/ops/{name}.py", text)
    made = tree_hashes(root)
    add_file(root, "fhebench/ops/square3.py", SQUARE3)
    toy.write(root, "fhebench/traffic/square3x2.json",
              {"op": "square3", "batch": 2, "level": 0, "warmup": 1,
               "profile_warmup": 1, "profile_requests": 1})
    bench["workloads"].append({"name": "toy-square3", "config": "ckks-logN15",
                               "traffic": "square3x2", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "hmult_per_s":
            m["workloads"].append("toy-square3")
    toy.write(root, "BENCHMARK.json", bench)
    return root, made


@pytest.mark.parametrize("others", [{}, {"other": OTHER}],
                         ids=["first", "beside_another"])
def test_operation_added_as_files_only(tmp_path, monkeypatch, others):
    root, made = add_square3(tmp_path, others)
    now = tree_hashes(root)
    assert {p for p in made if now.get(p) != made[p]} == {"BENCHMARK.json"}
    assert set(now) - set(made) == {"fhebench/ops/square3.py",
                                    "fhebench/traffic/square3x2.json"}
    res, checks = harness.run_cell(root, "toy-square3", SEED, 0.05, False,
                                   "cpu", log=quiet)
    assert res["correct"], checks
    assert res["metrics"]["hmult_per_s"]["value"] > 0
    assert {n for n, _, _ in checks} >= {"residue_mismatch.1",
                                         "residue_mismatch.3"}
    res, checks = harness.run_cell(root, "toy-square3", SEED, 0.05, True,
                                   "cpu", log=quiet)
    assert res["correct"], checks
    # no card: the window is one idle gap, its middle in the request
    assert [n for n, _ in res["breakdown"]["idle_gaps"]] == ["square3"]

    def last_level(orig, _before):
        def f(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            if out.level == 3:
                d = out.data[0]
                d[0, 0, 0] = (d[0, 0, 0] + 1) % self.params.q[out.level]
            return out
        return f

    at_window(monkeypatch, "cc_mult", last_level)
    res, checks = harness.run_cell(root, "toy-square3", SEED, 0.05, False,
                                   "cpu", log=quiet)
    assert not res["correct"]
    bad = {n for n, v, lim in checks if v > lim}
    assert bad == {"residue_mismatch.3"}, checks


def test_unknown_operation_names_its_file(tmp_path):
    root, _ = toy.make_root(tmp_path, client=False)
    toy.write(root, "fhebench/traffic/nothing.json",
              {"op": "no_such_op", "batch": 1, "warmup": 1})
    bench = harness.Bench(root)
    with pytest.raises(KeyError, match=r"fhebench/ops/no_such_op\.py"):
        bench.op(bench.mix("nothing")["op"])


def at_window(monkeypatch, method, wrap):
    """Break ``CkksEngine.<method>`` once the window opens, in whatever
    operation the cell runs (built in or of ``ops/<op>.py``), after that
    operation's own ``start_window``.  ``wrap(orig, before)`` makes the
    broken method from the method and ``before``, a list that holds the
    method's last output before the window."""
    orig = getattr(ckks_engine.CkksEngine, method)
    before = []

    def record(self, *args, **kwargs):
        before[:] = [orig(self, *args, **kwargs)]
        return before[0]

    monkeypatch.setattr(ckks_engine.CkksEngine, method, record)
    find = harness.Bench.op

    def op(bench, name):
        class Broken(find(bench, name)):
            def start_window(self):
                super().start_window()
                monkeypatch.setattr(ckks_engine.CkksEngine, method,
                                    wrap(orig, before))
        return Broken

    monkeypatch.setattr(harness.Bench, "op", op)


def unchanged(orig, _before):
    def f(self, *args, **kwargs):
        return args[0]
    return f


def half_batch(orig, _before):
    def f(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        for d in out.data:
            d[d.shape[0] // 2:] = 0
        return out
    return f


def altered(orig, _before):
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


def client_unchanged(orig, before):
    """Every window request gets the ciphertexts that the last request
    before the window got (another message of the pool)."""
    stale = before[0]

    def f(self, ms, *args, **kwargs):
        return stale
    return f


def client_half(orig, _before):
    def f(self, ms, *args, **kwargs):
        ms = list(ms)
        h = len(ms) // 2
        return orig(self, ms[:h] + ms[:h], *args, **kwargs)
    return f


def client_altered(orig, _before):
    def f(self, ms, *args, **kwargs):
        cts = orig(self, ms, *args, **kwargs)
        d = cts[0].data[0]
        d[1, 3] = (d[1, 3] + 1) % self.params.q[1]
        return cts
    return f


def decoded_altered(orig, _before):
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
