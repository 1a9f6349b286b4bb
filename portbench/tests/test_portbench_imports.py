"""No module of the benchmark imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is the port), and the
plain references import nothing of the port either."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_names(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not _top_names(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    files = sorted((HERE / "reference").glob("*.py"))
    assert len(files) >= 3
    for f in files:
        names = _top_names(f)
        assert "repro_torch" not in names, f
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), f


def test_guard_compares_whole_names():
    assert not {"repro_torch"} & FORBIDDEN
    from portbench import core
    assert "repro" in core.FORBIDDEN_MODULES
