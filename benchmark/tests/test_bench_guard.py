"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either: top-level module names
compared whole (``gnnome_tpu_torch`` is not ``gnnome_tpu``)."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "gnnome_tpu"}
PROGRAM = {"gnnome_tpu_torch"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    names = top_level_imports(path)
    assert not names & (FORBIDDEN | PROGRAM)
    # nor the benchmark's own modules that drive the program
    assert "benchmark" not in names or all(
        n.startswith("benchmark.reference") for n in _from_benchmark(path))


def _from_benchmark(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("benchmark"):
            yield node.module


def test_guard_compares_whole_names(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import gnnome_tpu.ops.segment\nfrom jax import numpy\n")
    good = tmp_path / "good.py"
    good.write_text("import gnnome_tpu_torch.ops.segment\nfrom jaxtyping import Array\n")
    assert top_level_imports(bad) & FORBIDDEN == {"gnnome_tpu", "jax"}
    assert not top_level_imports(good) & FORBIDDEN


def test_run_refuses_jax_modules(monkeypatch):
    import sys

    from benchmark import run

    monkeypatch.setitem(sys.modules, "gnnome_tpu_torch_probe", object())
    assert "gnnome_tpu_torch_probe" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gnnome_tpu.probe", object())
    assert "gnnome_tpu.probe" in run.forbidden_modules()
