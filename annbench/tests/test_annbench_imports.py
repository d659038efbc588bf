"""No file of the benchmark imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), and
the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the yardstick: what decides ``correct`` and the rooflines
YARDSTICK = ("reference.py", "checks/exact_ivfpq.py", "roofline.py",
             "draws/ivfpq.py", "kinds/closed_batch.py", "trace.py",
             "calibrate.py")


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_files_found():
    assert HERE / "reference.py" in FILES and len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in _top_level_imports(HERE / name)


def test_whole_names_are_compared(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import repro_torch.service\nfrom reprox import y\n")
    assert not _top_level_imports(p) & FORBIDDEN
    p.write_text("from repro.core import search\n")
    assert _top_level_imports(p) & FORBIDDEN == {"repro"}
