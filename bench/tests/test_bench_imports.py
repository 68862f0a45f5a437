"""Nothing under the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: every import of every module
parsed, its top-level name compared whole."""
from __future__ import annotations

import ast

import pytest

from conftest import ROOT

BENCH = ROOT / "bench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    bad = {"jax", "jaxlib", "flax", "repro"} & set(_imports(path))
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_imports(path))


def test_the_check_compares_whole_names():
    from bench.harness.main import FORBIDDEN
    assert "repro" in FORBIDDEN and "repro_torch".split(".")[0] \
        not in FORBIDDEN
