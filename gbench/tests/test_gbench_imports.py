"""No file of the benchmark imports JAX or the JAX package, and the plain
references import nothing of the program: top-level module names compared
whole (``repro_torch`` begins with ``repro`` and is allowed outside
``reference/``)."""
import ast

import pytest

from gbench_testlib import GBENCH

NEVER = {"jax", "jaxlib", "flax", "repro"}
PROGRAM = {"repro_torch"}


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(p for p in GBENCH.rglob("*.py") if "_cache" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(GBENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & NEVER


def test_references_stand_alone():
    refs = sorted((GBENCH / "reference").glob("*.py"))
    assert refs
    for path in refs:
        assert not top_level_imports(path) & (NEVER | PROGRAM), path


def test_scanner_compares_whole_names(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import repro_torch.core\nfrom jax.numpy import zeros\n"
                 "import reprox\n")
    assert top_level_imports(p) == {"repro_torch", "jax", "reprox"}
