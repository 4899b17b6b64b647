"""Nothing under portbench/ imports JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` is not ``repro``), and the
references import nothing of the program."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(ROOT.rglob("*.py"))


def imported(path: pathlib.Path) -> set[str]:
    """Top-level names of every module ``path`` imports (relative imports
    are the benchmark's own)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)
    assert "portbench" not in imported(path)


def test_the_check_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import repro.models\nfrom jax import numpy\n"
                   "import repro_torch\n")
    assert imported(bad) & FORBIDDEN == {"repro", "jax"}


def test_run_refuses_a_loaded_forbidden_module(monkeypatch):
    import sys
    import types
    from portbench import run
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("x"))
    assert "jaxlib" in run.loaded_forbidden()
