"""What the benchmark loads: no JAX, no JAX package, and a reference
that owes nothing to the program under test."""

import ast
import os
import subprocess
import sys

from fhebench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def imported(path):
    """Top-level names of the modules a source file imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(*parts):
    top = os.path.join(HERE, *parts)
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_top_level_names_compared_whole():
    mods = ["tiberate_tpu_torch", "tiberate_tpu_torch.engine", "jaxtyping",
            "flaxen", "numpy"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["tiberate_tpu.ops.mont"]) == [
        "tiberate_tpu"]
    assert harness.forbidden_modules(["jaxlib.xla_client", "jax",
                                      "flax.linen"]) == ["flax", "jax",
                                                         "jaxlib"]


def test_harness_sources_import_no_jax():
    for path in sources():
        bad = imported(path) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        names = imported(path)
        assert "tiberate_tpu_torch" not in names, path
        assert not names & set(harness.FORBIDDEN), path


def test_operations_import_nothing_of_the_program(tmp_path):
    """An operation file (``ops/<op>.py``) reaches the program only
    through the engine that ``generator`` builds, so that its check
    compares against the reference and not the program's own code."""
    program = {"tiberate_tpu_torch", *harness.FORBIDDEN}
    for path in sources("ops"):
        assert not imported(path) & program, path
    bad = tmp_path / "op.py"
    bad.write_text("from fhebench import generator\n"
                   "from tiberate_tpu_torch.engine import ckks_engine\n")
    assert imported(str(bad)) & program == {"tiberate_tpu_torch"}


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import fhebench.reference.ckks, "
            "fhebench.roofline.work; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = eval(out)  # noqa: S307 — our own printed list
    assert "tiberate_tpu_torch" not in loaded
    assert not set(loaded) & set(harness.FORBIDDEN)


def test_a_cpu_run_loads_no_jax(tmp_path):
    """A whole run of a toy cell in a fresh process, the program
    included, leaves no JAX module loaded."""
    code = (
        "import sys; from fhebench.tests import toy; "
        "from fhebench import harness; "
        f"root, _ = toy.make_root({str(tmp_path)!r}); "
        "harness.run_cell(root, 'logN15-mult8', 11, 0.1, False, 'cpu', "
        "log=lambda m: None); print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
