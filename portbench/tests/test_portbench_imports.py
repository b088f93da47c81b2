"""No module under portbench/ imports JAX or the JAX package ``repro``
(top-level names compared whole, so ``repro_torch`` passes), and the
reference imports nothing of the port."""
import ast
from pathlib import Path

import pytest

from portbench import run, spec

FILES = sorted(spec.HERE.rglob("*.py"))


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(spec.HERE)))
def test_no_jax(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


def test_reference_is_plain():
    for path in (spec.HERE / "reference").glob("*.py"):
        assert "repro_torch" not in _imports(path), path
        text = path.read_text()
        assert "portbench.program" not in text and "portbench.run" not in text


def test_forbidden_modules_by_whole_name():
    assert run.forbidden_modules(["repro_torch", "repro_torch.models",
                                  "jaxtyping", "portbench.run"]) == []
    assert run.forbidden_modules(["repro.models", "jax", "flax.linen",
                                  "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                 "repro"]
