"""What the benchmark may import and read."""

import ast
import re
from pathlib import Path

from posebench.harness import FORBIDDEN_MODULES, forbidden_loaded

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _sources():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    bad = [(str(p.relative_to(BENCH)), m) for p in _sources()
           for m in _imports(p) if m.split(".")[0] in FORBIDDEN_MODULES]
    assert bad == []


def test_reference_imports_nothing_of_the_program():
    bad = [(p.name, m) for p in sorted((BENCH / "reference").glob("*.py"))
           for m in _imports(p) if m.split(".")[0] == "tpupose_torch"]
    assert bad == []


def test_nothing_reads_the_tpu_benchmark_files():
    for p in _sources():
        text = p.read_text()
        if p.name == Path(__file__).name:
            continue
        assert not re.search(r"BENCH_[A-Za-z]|[^a-z_]bench\.py", text), p


def test_forbidden_loaded_compares_whole_top_level_names():
    assert forbidden_loaded({"tpupose_torch": 1, "tpupose_torch.ops": 1,
                             "jaxtyping": 1, "torch": 1}) == []
    assert forbidden_loaded({"jax.numpy": 1, "tpupose.ops": 1,
                             "flax": 1}) == ["flax", "jax", "tpupose"]
