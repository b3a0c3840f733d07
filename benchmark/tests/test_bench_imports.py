"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port: top-level names compared whole."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

from benchmark.harness.core import BENCH_DIR, FORBIDDEN_MODULES, forbidden_loaded

PORT = "confignet_tpu_torch"


def imported_top_levels(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


MODULES = sorted(p for p in BENCH_DIR.rglob("*.py") if "_cache" not in p.parts)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_imports(path):
    assert set(imported_top_levels(path)) & set(FORBIDDEN_MODULES) == set()


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(imported_top_levels(path))


def test_names_are_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "confignet_tpu_torch_fake", types.ModuleType("x"))
    assert "confignet_tpu" not in forbidden_loaded()
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("flax.linen"))
    assert "flax" in forbidden_loaded()
