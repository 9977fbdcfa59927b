"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import os

import pytest

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "ndjir_tpu"}
BENCH = os.path.join(REPO, "benchmark")


def imported_top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def python_files(top):
    for base, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


@pytest.mark.parametrize("path", sorted(python_files(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted(python_files(os.path.join(BENCH, "reference"))),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert "ndjir_torch" not in imported_top_names(path)


def test_the_checker_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import ndjir_torch.ops\nfrom jax import numpy\n")
    assert imported_top_names(str(p)) == {"ndjir_torch", "jax"}
    assert "ndjir_torch" not in FORBIDDEN
