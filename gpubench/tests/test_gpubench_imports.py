"""No module of the benchmark imports JAX, Flax, Optax or the JAX package
``repurpose_tpu`` (top-level names compared whole: ``repurpose_tpu_torch``
is not ``repurpose_tpu``), and the plain reference imports nothing of the
port."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "repurpose_tpu"}


def top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


REFERENCE = sorted((HERE / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFERENCE, ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_port(path):
    assert "repurpose_tpu_torch" not in top_level_imports(path)
    # and nothing of the harness that does
    harness = {"run", "common", "control", "drivers", "readers"}
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("gpubench"):
            mods |= {node.module.split(".")[1] if "." in node.module else a.name
                     for a in node.names}
    assert not mods & harness


def test_whole_names():
    assert "repurpose_tpu_torch" not in FORBIDDEN
    assert top_level_imports(HERE / "drivers" / "trainer.py") >= {"repurpose_tpu_torch"}
