"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py`` or the scripts in ``tools/``) imports JAX or the JAX
package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_repro(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_the_walk_sees_the_port():
    names = {p.name for p in FILES}
    assert {"executor.py", "train_step.py", "_build.py", "pipeline.py",
            "driver.py", "faults.py", "checkpoint.py",
            "chip_smoke.py"} <= names
    # the sparse allreduce library, its collectives and the classification
    # entry point
    assert {"sparse_stream.py", "density.py", "cost_model.py",
            "collectives.py", "allreduce.py", "sparse_datasets.py",
            "run_classify.py"} <= names
    # observability and the adaptive re-planning loop
    assert {"metrics.py", "trace.py", "recorder.py", "health.py",
            "audit.py", "report.py", "adapt.py", "calibrate.py"} <= names
    assert (ROOT / "src" / "repro_torch" / "obs" / "__init__.py") in FILES
    # serving
    assert {"engine.py", "scheduler.py", "sparse_decode.py",
            "run_serve.py"} <= names
    # the dry run, its report, the roofline, the op counter, quickstart
    assert {"dryrun.py", "roofline_report.py", "roofline.py", "op_cost.py",
            "quickstart.py"} <= names
