"""Nothing under benchmark/ imports jax, jaxlib, flax or the JAX package
(top-level module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

from csbench import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "clearsky_tpu"}
FILES = sorted(p for p in registry.BENCH.rglob("*.py") if "__pycache__" not in p.parts)
REFERENCE = sorted((registry.BENCH / "csbench" / "reference").glob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(registry.BENCH)))
def test_no_jax_anywhere(path):
    assert not (top_level_imports(path) & FORBIDDEN), path


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "numpy", "torch"}, path


PROGRAM_SIDE = {"system.py"} | {p.name for p in (registry.BENCH / "absorbers").glob("*.py")}


def test_the_harness_touches_the_program_in_few_modules():
    """The program is imported, inside functions, only by ``system.py`` and
    by the absorbers' files (which build the program's absorbers); never by
    the reference, the cores' references, the kinds, the metrics."""
    users = {p.name for p in FILES if "tests" not in p.parts
             and "clearsky_tpu_torch" in top_level_imports(p)}
    lazy = {p.name for p in FILES if "tests" not in p.parts
            and "import clearsky_tpu_torch" in p.read_text()}
    assert users <= PROGRAM_SIDE and lazy <= PROGRAM_SIDE, (users, lazy)
    for p in FILES:
        if "import clearsky_tpu_torch" in p.read_text() and "tests" not in p.parts:
            assert not any(line.startswith("import clearsky_tpu_torch")
                           for line in p.read_text().splitlines()), p


@pytest.mark.parametrize("path", sorted((registry.BENCH / "cores").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_cores_references_import_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "numpy", "torch", "csbench"}, path


def test_the_names_are_compared_whole():
    import sys

    from csbench.cli import forbidden_loaded

    sys.modules.setdefault("clearsky_tpu_torch_fake_probe", sys)
    try:
        assert "clearsky_tpu" not in forbidden_loaded()
    finally:
        del sys.modules["clearsky_tpu_torch_fake_probe"]
