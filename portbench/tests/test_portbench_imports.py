"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Top-level module names (the part
before the first dot) are compared whole: ``moonrtx_tpu_torch`` is the
port, ``moonrtx_tpu`` the JAX package."""

import ast
from pathlib import Path

import pytest

from harness.cell import FORBIDDEN, forbidden_modules

BENCH_DIR = Path(__file__).resolve().parents[1]
PORT = "moonrtx_tpu_torch"


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def sources():
    return sorted(p for p in BENCH_DIR.rglob("*.py")
                  if ".cache" not in p.parts and "out" not in p.parts)


def test_the_name_check_compares_whole_top_level_names():
    assert forbidden_modules([PORT, PORT + ".kernels", "numpy"]) == []
    assert forbidden_modules(["moonrtx_tpu", "moonrtx_tpu.engine",
                              "jax.numpy", "jaxlib", "flax.linen",
                              "jaxtyping"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "moonrtx_tpu",
        "moonrtx_tpu.engine"]


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not imported_tops(path) & {"jax", "jaxlib", "flax", "moonrtx_tpu"}
    assert set(FORBIDDEN) >= {"jax", "moonrtx_tpu"}


@pytest.mark.parametrize(
    "path", [p for p in sources() if "reference" in p.parts],
    ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported_tops(path)


def test_the_walk_sees_what_it_should():
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "m.py"
        p.write_text("import moonrtx_tpu.engine as e\nfrom jax import numpy\n"
                     "import moonrtx_tpu_torch\n"
                     "importlib.import_module('jaxlib.x')\n")
        assert imported_tops(p) == {"moonrtx_tpu", "jax", PORT, "jaxlib"}
