"""The program's spans (``tiberate_tpu_torch/utils/trace.py``) on the CPU at
a toy ring: nothing recorded and no ``record_function`` entered without a
profiler; under ``trace.profile`` the span tree of ``cc_mult``, ``sum``
and the client pair, each child inside its parent, one root id a call,
the port's CUDA kernels counted (on the CPU those its plain versions
stand in for: two a transform, one a glue kernel) and the root's first
launch stamped; the chrome trace holds every span's name; the records
are bounded.  On the card (marked ``cuda``, skipped without one) each
span's count equals the port's kernels whose launches the chrome trace
holds inside the span's range:

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py -q
"""

import collections
import json

import numpy as np
import pytest
import torch

from tiberate_tpu_torch.config.toy import toy_config
from tiberate_tpu_torch.engine import CkksEngine
from tiberate_tpu_torch.ops import ntt_kernels
from tiberate_tpu_torch.utils import trace

KEYSWITCH = ("keyswitch", ())
STEP = ("cc_mult", (("cc_mult.prepare", ()), ("step.rescale", ()),
                    ("step.tensor", ()),
                    ("step.relin", (KEYSWITCH, ("relin.close", ())))))
ROTATION = ("rotate_single", (("rotate.permute", ()),
                              ("switch_key", (KEYSWITCH,
                                              ("switch_key.close", ())))))
CLIENT = (("encodecrypt_batch", (("encode", ()), ("draw", ()),
                                 ("encrypt", ()))),
          ("decryptcode_batch", (("decrypt", ()), ("decode", ()))))


@pytest.fixture(scope="module")
def eng():
    eng = CkksEngine(toy_config(logN=6, num_scales=3, num_special_primes=1),
                     device="cpu", seed=5)
    for i in range(eng.ckksCfg.logN - 1):   # the keys, before any span
        eng.get_rotation_key(2**i)
    return eng


@pytest.fixture(scope="module")
def msgs(eng):
    rng = np.random.default_rng(5)
    return rng.uniform(-1, 1, (2, eng.num_slots))


@pytest.fixture(scope="module")
def cts(eng, msgs):
    return eng.encodecrypt(msgs[0]), eng.encodecrypt(msgs[1])


def ops(eng, msgs, cts):
    a, b = cts
    return {
        "cc_mult": (lambda: eng.cc_mult(a, b), (STEP,)),
        "sum": (lambda: eng.sum(a),
                (("sum", (ROTATION,) * (eng.ckksCfg.logN - 1)),)),
        "client": (lambda: eng.decryptcode_batch(
            eng.encodecrypt_batch(list(msgs)), is_real=True), CLIENT),
    }


def shape(recs, parent=None):
    """The records' tree of names under ``parent`` (None: the roots)."""
    return tuple((r.name, shape(recs, r.index)) for r in recs
                 if r.parent == parent)


def names(tree):
    return {n for name, kids in tree for n in {name} | names(kids)}


def test_no_profiler_no_span(monkeypatch, eng, msgs, cts):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(trace, "record_function", refuse)
    trace.clear()
    for run, _ in ops(eng, msgs, cts).values():
        run()
    assert trace.spans() == []
    assert trace._root is None
    assert trace.annotate("cc_mult") is trace._OFF


@pytest.mark.parametrize("op", ["cc_mult", "sum", "client"])
def test_span_tree_under_profile(tmp_path, eng, msgs, cts, op):
    run, tree = ops(eng, msgs, cts)[op]
    trace.clear()
    with trace.profile(str(tmp_path)) as path:
        run()
    recs = trace.spans()
    assert shape(recs) == tree
    assert [r.index for r in recs] == list(range(len(recs)))
    by_index = {r.index: r for r in recs}
    for r in recs:
        assert r.t0 <= r.t1
        if r.parent is None:
            assert r.root == r.index
            assert r.t0 < r.first_launch <= r.t1
        else:
            p = by_index[r.parent]
            assert p.t0 <= r.t0 and r.t1 <= p.t1
            assert r.root == p.root and r.first_launch is None
            assert r.launches <= p.launches
    with open(path) as f:
        events = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert names(tree) <= events
    assert trace._root is None

    counts = {}
    for r in recs:
        counts.setdefault(r.name, set()).add(r.launches)
    # the keyswitch: G2, K6, then K2 + G3 + K4 for each accumulator, each
    # transform (K2, K4, K6) two passes: 13 kernels
    if op != "client":
        assert counts["keyswitch"] == {13}
    if op == "cc_mult":
        (root,) = (r for r in recs if r.parent is None)
        (rescale,) = (r for r in recs if r.name == "step.rescale")
        assert root.first_launch <= rescale.t1
        # 4 G1, K5's two passes, 3 K2 of two, the keyswitch
        assert counts == {"cc_mult": {25}, "cc_mult.prepare": {0},
                          "step.rescale": {4}, "step.tensor": {2},
                          "step.relin": {19}, "keyswitch": {13},
                          "relin.close": {0}}
    if op == "sum":
        assert counts["rotate_single"] == counts["switch_key"] == {13}
        assert counts["rotate.permute"] == {0}
        # each rotation's 13, then the running cc_add: one G4 a polynomial
        assert counts["sum"] == {(13 + 2) * (eng.ckksCfg.logN - 1)}


def test_records_bounded(monkeypatch, tmp_path):
    """Past the bound the oldest records go; the first kept index counts
    them."""
    monkeypatch.setattr(trace, "_records", collections.deque(maxlen=4))
    trace.clear()
    with trace.profile(str(tmp_path)):
        for i in range(6):
            with trace.annotate(f"s{i}"):
                pass
    recs = trace.spans()
    assert [r.name for r in recs] == ["s2", "s3", "s4", "s5"]
    assert recs[0].index == 2
    assert all(r.parent is None and r.launches == 0
               and r.first_launch is None for r in recs)
    trace.clear()
    assert trace.spans() == []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_hold_their_launches_on_card(card, tmp_path):
    """A ``cc_mult`` on the card: each span is a range of the chrome
    trace, and its count is the port's kernels whose launches lie inside
    that range (the trace's other kernels are torch's)."""
    eng = CkksEngine(toy_config(logN=10, num_scales=4, num_special_primes=2,
                                scale_bits=30), device=card, seed=5)
    rng = np.random.default_rng(3)
    a, b = (eng.encodecrypt(rng.uniform(-1, 1, eng.num_slots))
            for _ in range(2))
    eng.cc_mult(a, b)                     # the step's caches, untraced
    torch.cuda.synchronize()
    before = dict(ntt_kernels.LAUNCHES)
    trace.clear()
    with trace.profile(str(tmp_path)) as path:
        eng.cc_mult(a, b)
    calls = sum(n - before.get(k, 0) for k, n in ntt_kernels.LAUNCHES.items())
    recs = trace.spans()
    assert shape(recs) == (STEP,)
    root = recs[0]
    assert calls == 16 and root.launches == 25
    assert root.t0 < root.first_launch <= root.t1

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"]: e for e in events
              if e.get("cat") == "user_annotation" and e["name"] in
              names((STEP,))}
    assert set(ranges) == names((STEP,))
    kernel = {e["args"]["correlation"]: e["name"] for e in events
              if e.get("cat") == "kernel"}
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", "")]
    torch_launches = 0
    for r in recs:
        span = ranges[r.name]
        inside = [kernel[e["args"]["correlation"]] for e in launches
                  if span["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= span["ts"] + span["dur"]]
        port = [k for k in inside if "at::" not in k]
        assert len(port) == r.launches, (r.name, inside)
        if r is root:
            torch_launches = len(inside) - len(port)
    assert torch_launches > 0
