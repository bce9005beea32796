"""The readers of the program's own spans (``fhebench/program.py``,
``metrics/prelude_ms.py``, ``dispatch_ms.py``, ``torch_launches_per_*``)
at a toy ring on the CPU.  Without a card the trace holds no kernels and
the readers read nothing; a stand-in count of the card's kernels (as an
H100's trace counts them: 37 a logN15 step, 59 a rotation) lets them
read the program's records of a traced run."""

import types

import pytest
from tiberate_tpu_torch.utils import trace

from fhebench import harness, program
from fhebench import trace as tracelib
from fhebench.tests import toy

SEED = 2**33 + 5
NEW = {"prelude_ms.hmult", "prelude_ms.hmult.logN15",
       "dispatch_ms.hmult.logN15", "torch_launches_per_step.hmult.logN15",
       "torch_launches_per_rot.hrot"}
# cell -> the card's kernels a request, over the toy's
# requests: a step, or a sum of logN - 1 rotations
CARD_KERNELS = {"logN17-mult8": lambda logN: 37,
                "logN15-mult8": lambda logN: 37,
                "logN15-rotsum8": lambda logN: 59 * (logN - 1)}


def quiet(msg):
    pass


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.make_root(tmp_path_factory.mktemp("bench"), client=False)[0]


def cell_info(root, cell):
    """(the mix's operation, the configuration's logN) of a cell."""
    bench = harness.Bench(root)
    c = bench.cell(cell)
    return bench.mix(c["traffic"])["op"], bench.config(c["config"])["logN"]


def with_card_kernels(monkeypatch, per_request):
    """The harness's trace with ``per_request`` kernels a request, as a
    card's trace would count them."""
    capture = tracelib.capture

    def fake(*args, **kwargs):
        tr = capture(*args, **kwargs)
        tr.kernels = per_request * tr.requests
        return tr

    monkeypatch.setattr(tracelib, "capture", fake)


def test_untraced_run_records_nothing(root):
    trace.clear()
    res, _ = harness.run_cell(root, "logN15-mult8", SEED, 0.05, False, "cpu",
                              log=quiet)
    assert res["correct"]
    assert trace.spans() == []


@pytest.mark.parametrize("cell", sorted(CARD_KERNELS))
def test_no_card_kernels_no_reading(root, cell):
    res, _ = harness.run_cell(root, cell, SEED, 0.05, True, "cpu",
                              log=quiet)
    assert res["correct"]
    assert not NEW & set(res["metrics"])
    op, _ = cell_info(root, cell)
    assert any(r.name == op and r.parent is None for r in trace.spans())


@pytest.mark.parametrize("cell", sorted(CARD_KERNELS))
def test_traced_run_reads_the_program(root, monkeypatch, cell):
    _, logN = cell_info(root, cell)
    with_card_kernels(monkeypatch, CARD_KERNELS[cell](logN))
    res, _ = harness.run_cell(root, cell, SEED, 0.05, True, "cpu",
                              log=quiet)
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items() if k in NEW}
    if cell == "logN17-mult8":
        assert set(got) == {"prelude_ms.hmult"}
        assert got["prelude_ms.hmult"] > 0
    elif cell == "logN15-mult8":
        assert set(got) == {"prelude_ms.hmult.logN15",
                            "dispatch_ms.hmult.logN15",
                            "torch_launches_per_step.hmult.logN15"}
        assert (0 < got["prelude_ms.hmult.logN15"]
                <= got["dispatch_ms.hmult.logN15"])
        # 37 less the step's 25 kernels: 4 G1, K5, 3 K2, then the
        # keyswitch's G2, K6, 2 K2, 2 G3, 2 K4, each transform two passes
        assert got["torch_launches_per_step.hmult.logN15"] == 12
    else:
        # 59 less the rotation's 13: the keyswitch's
        assert got == {"torch_launches_per_rot.hrot": 46}


def test_program_without_records_reads_nothing(root, monkeypatch):
    """A program with no ``trace.spans`` (the benchmark laid over an
    older checkout) gives None, and raises nothing."""
    with_card_kernels(monkeypatch, 37)
    monkeypatch.setattr(program, "trace", types.SimpleNamespace())
    res, _ = harness.run_cell(root, "logN15-mult8", SEED, 0.05, True, "cpu",
                              log=quiet)
    assert res["correct"]
    assert not NEW & set(res["metrics"])


def test_launches_of_every_root_span(monkeypatch):
    """A request that opens several root spans of several names (as a
    circuit of ``cc_mult``s and ``mult_scalar``s does): torch's launches
    are the kernels a request less the launches of all its roots."""
    def rec(name, launches):
        return types.SimpleNamespace(name=name, parent=None, t0=2.0,
                                     t1=3.0, launches=launches)

    request = [rec("cc_mult", 25), rec("cc_mult", 25),
               rec("mult_scalar", 3)]
    monkeypatch.setattr(program, "trace", types.SimpleNamespace(
        spans=lambda: 2 * request))
    run = types.SimpleNamespace(
        trace=types.SimpleNamespace(kernels=2 * (53 + 12), requests=2),
        requests=[types.SimpleNamespace(t1=1.0)])
    assert program.torch_launches(run, 1) == 12
    assert program.torch_launches(run, 3) == 4
    assert len(program.roots(run, "cc_mult")) == 4
