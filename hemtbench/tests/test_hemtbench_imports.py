"""Nothing of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the
references import nothing of the port."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(top_level_imports(path))
    assert "repro_torch" not in names and "benchmarks" not in names
    assert names <= {"__future__", "contextlib", "math", "typing", "torch", "hemtbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith("hemtbench"):
            assert node.module.startswith("hemtbench.reference")


def test_the_walk_sees_the_names_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.models\nfrom repro_torch import x\nimport jaxlib.xla\n"
                   "from repro.core import y\n")
    names = list(top_level_imports(src))
    assert names == ["repro_torch", "repro_torch", "jaxlib", "repro"]
    assert set(names) & FORBIDDEN == {"jaxlib", "repro"}


def test_nothing_imports_the_reference_harness():
    for path in SOURCES:
        assert "benchmarks" not in set(top_level_imports(path)), path
