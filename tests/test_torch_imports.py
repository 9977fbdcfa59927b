"""The port imports nothing of the JAX package: every module of
``ndjir_torch/``, ``chip_smoke.py`` and the port's ``scripts/torch_*.py``
parsed with ``ast``.  No import of ``ndjir_tpu``, ``jax`` or ``flax``
anywhere in them (also not inside a function, nor by ``__import__`` or
``importlib.import_module``), and no module-level import of a library the
card's machine lacks; such a library may only be imported inside the
function that needs it (``h5py`` in the reference-checkpoint import)."""

import ast
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# never imported by the port
FORBIDDEN = ("ndjir_tpu", "jax", "flax")
# not on the card's machine: never imported when a module is imported
ABSENT_ON_CARD = ("imageio", "PIL", "cv2", "matplotlib", "yaml", "msgpack",
                  "h5py")

FILES = sorted(
    glob.glob(os.path.join(REPO, "ndjir_torch", "**", "*.py"), recursive=True)
    + [os.path.join(REPO, "chip_smoke.py")]
    + glob.glob(os.path.join(REPO, "scripts", "torch_*.py")))


def _top(name: str) -> str:
    return name.split(".")[0]


def imports(source: str):
    """(top-level package, line, at module level) of every absolute import
    in ``source``: import statements, and ``__import__`` /
    ``importlib.import_module`` calls with a constant name.  An import is
    at module level unless it lies inside a function (a module-level
    ``if``/``try`` still runs on import)."""
    out = []

    def visit(node, in_function):
        for child in ast.iter_child_nodes(node):
            inner = in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if isinstance(child, ast.Import):
                out.extend((_top(a.name), child.lineno, not in_function)
                           for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((_top(child.module), child.lineno,
                            not in_function))
            elif isinstance(child, ast.Call) and child.args \
                    and isinstance(child.args[0], ast.Constant) \
                    and isinstance(child.args[0].value, str):
                f = child.func
                name = f.id if isinstance(f, ast.Name) else \
                    f.attr if isinstance(f, ast.Attribute) else None
                if name in ("__import__", "import_module"):
                    out.append((_top(child.args[0].value), child.lineno,
                                not in_function))
            visit(child, inner)

    visit(ast.parse(source), False)
    return out


def violations(source: str):
    return [f"line {line}: {mod}" for mod, line, top in imports(source)
            if mod in FORBIDDEN or (top and mod in ABSENT_ON_CARD)]


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, REPO) for p in FILES])
def test_module_imports_nothing_of_jax(path):
    with open(path) as f:
        found = violations(f.read())
    assert found == [], f"{os.path.relpath(path, REPO)}: {found}"


def test_every_port_module_is_checked():
    names = {os.path.relpath(p, REPO) for p in FILES}
    for module in ("ndjir_torch/tools/colmap.py",
                   "ndjir_torch/tools/normalize_cameras.py",
                   "ndjir_torch/tools/import_reference.py",
                   "ndjir_torch/tools/mesh_post.py",
                   "ndjir_torch/tools/viewers.py",
                   "ndjir_torch/tools/images.py",
                   "ndjir_torch/utils/profiling.py",
                   "ndjir_torch/utils/runtime.py", "chip_smoke.py"):
        assert module in names
    assert len(names) > 50


@pytest.mark.parametrize("source,want", [
    ("import jax\n", ["line 1: jax"]),
    ("import jax.numpy as jnp\n", ["line 1: jax"]),
    ("from flax import serialization\n", ["line 1: flax"]),
    ("def f():\n    from ndjir_tpu.tools import colmap\n",
     ["line 2: ndjir_tpu"]),
    ("def f():\n    import jax\n", ["line 2: jax"]),
    ("class A:\n    def g(self):\n        import flax\n", ["line 3: flax"]),
    ("x = __import__('jax')\n", ["line 1: jax"]),
    ("import importlib\nm = importlib.import_module('ndjir_tpu.cli')\n",
     ["line 2: ndjir_tpu"]),
    ("import imageio.v2 as imageio\n", ["line 1: imageio"]),
    ("try:\n    import yaml\nexcept ImportError:\n    pass\n",
     ["line 2: yaml"]),
    ("from PIL import Image\n", ["line 1: PIL"]),
    ("def read(p):\n    import h5py\n", []),
    ("def show():\n    import matplotlib.pyplot as plt\n", []),
    ("from . import x\nfrom .jax import y\nimport numpy, torch\n", []),
    ("import jaxlib_like_name\nimport ndjir_torch\n", []),
])
def test_the_check_finds_each_kind_of_import(source, want):
    assert violations(source) == want
