"""The port's hand-written CUDA kernels: build, load and launch counts.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point.  It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``csrc/build/`` (listed in ``.gitignore``) the first time it is needed, and
loaded with ``ctypes``; a library whose source or flags changed is rebuilt
(the file name carries their hash).  Nothing is built when this module is
imported.

``LAUNCHES`` counts, per kernel, the launches its wrapper made, and a replay
of a captured training step adds the launches its capture recorded
(:mod:`ndjir_torch.train.graph`); a run resets the counts and reads them
back to show which kernels a path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")

# kernel name -> source file under csrc/
SOURCES = {"scatter_add_rows": "scatter_add_rows.cu",
           "fold_octa_cotangent": "fold_octa_cotangent.cu",
           "build_octa_table": "build_octa_table.cu",
           "lanczos_voxel_gather": "lanczos_voxel_gather.cu",
           "adam_update": "adam_update.cu"}

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc on the machine with the "
                           "card")
    return nvcc


def library_path(name: str) -> str:
    with open(os.path.join(_CSRC, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: List[str] | None = None) -> Dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, all started together.  Returns each
    compiler's ``-Xptxas -v`` report (registers, spills, shared memory);
    raises if any build fails."""
    names = list(SOURCES) if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp,
               os.path.join(_CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{reports[name]}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        _LIBS[name] = lib
    return lib
