"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import harness

HERE = Path(harness.HERE)
PORT = "voicesplit_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "voicesplit_tpu_torch.fake_child", object())
    assert "voicesplit_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "voicesplit_tpu.models", object())
    assert harness.forbidden_modules() == ["voicesplit_tpu"]
    monkeypatch.setitem(sys.modules, "jax", object())
    assert harness.forbidden_modules() == ["jax", "voicesplit_tpu"]


def test_sources_import_no_jax():
    for path in HERE.rglob("*.py"):
        found = set(_imports(path)) & {"jax", "jaxlib", "flax", "voicesplit_tpu"}
        assert not found, (path, found)


def test_only_program_imports_the_port():
    for path in HERE.glob("*.py"):
        if path.name != "program.py":
            assert PORT not in set(_imports(path)), path
    assert PORT in set(_imports(HERE / "program.py"))


def test_reference_stands_alone():
    """The reference imports torch and, of the benchmark, only `costs` (the
    conv stack's layer list, which the weights' layout reads too): nothing
    of the program, and `costs` imports nothing at all of note."""
    assert set(_imports(HERE / "reference.py")) <= {"__future__", "typing", "torch", "costs"}
    assert set(_imports(HERE / "costs.py")) <= {"__future__", "typing"}
