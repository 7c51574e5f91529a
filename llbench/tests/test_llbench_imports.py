"""What the benchmark imports: never JAX, the JAX package or the port's
old benchmark, and a reference that imports nothing of the program."""
from __future__ import annotations

import ast
import os

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "llicti_tpu", "bench_torch"}
SOURCES = sorted(
    os.path.join(d, f) for d, _, fs in os.walk(os.path.join(ROOT, "llbench"))
    if "__pycache__" not in d for f in fs if f.endswith(".py"))


def top_level_imports(path: str):
    """Top-level names (the part before the first dot, whole) of every
    absolute import in a source file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_reference_imports_nothing_of_the_program(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            # inside the reference package only
            assert node.level == 1, (path, node.module)
    assert set(top_level_imports(path)) <= {"__future__", "contextlib",
                                            "typing", "numpy", "torch"}


def test_top_level_names_compared_whole():
    """The port's name begins with the JAX package's: only a whole
    top-level name counts."""
    from llbench import run
    assert run.forbidden_modules(["llicti_tpu_x", "llicti_torch.codec",
                                  "jaxlike.sub", "torch"]) == []
    assert run.forbidden_modules(["flax.core", "llicti_tpu.codec", "jax",
                                  "jaxlib.xla"]) == ["flax", "jax", "jaxlib",
                                                     "llicti_tpu"]
