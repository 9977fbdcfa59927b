"""The port's native code: build, load, launch and launch counts.

Each library in ``LIBRARIES`` is one source under ``csrc/`` with plain C
entry points: the seven hand-written CUDA kernels, compiled with ``nvcc`` for
Hopper (``sm_90a``), and the mesh library (``marching_cubes.cpp``, the port's
copy of the JAX package's), compiled with ``g++`` with the flags of the JAX
package's ``csrc/Makefile`` and wrapped by :mod:`ndjir_torch.extract.native`.
A library is compiled into ``csrc/build/`` (listed in ``.gitignore``) the
first time it is needed and loaded with ``ctypes``, its functions' argument
types bound once; one whose source or flags changed is rebuilt (the file
name carries their hash).  Nothing is built when this module is imported.

A CUDA entry point returns a ``cudaError`` and takes its stream last:
:func:`launch` passes the device's current stream and raises on an error.
``LAUNCHES`` counts, per CUDA kernel, the launches its wrapper made
(:func:`count`), and a replay of a captured training step adds the launches
its capture recorded (:mod:`ndjir_torch.train.graph`); a run resets the
counts and reads them back to show which kernels a path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, NamedTuple, Tuple

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")

# compiler -> its flags
_FLAGS = {"nvcc": ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"],
          "g++": ["-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native",
                  "-shared"]}
_MISSING = {"nvcc": "the CUDA kernels are built with the CUDA toolkit's "
                    "nvcc on the machine with the card",
            "g++": "the native mesh library is built with g++"}
# where a compiler not on PATH is looked for
_WHERE = {"nvcc": "/usr/local/cuda/bin/nvcc"}


class Library(NamedTuple):
    source: str                     # file under csrc/
    compiler: str                   # a key of _FLAGS
    # C symbol -> argument types; each returns an int (a cudaError, or a
    # count where the function launches nothing) unless ``restypes`` says
    functions: Dict[str, Tuple]
    restypes: Dict[str, object] = {}


_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_pf, _pi, _i64 = ctypes.POINTER(_f), ctypes.POINTER(_i), ctypes.c_int64
LIBRARIES: Dict[str, Library] = {
    "scatter_add_rows": Library("scatter_add_rows.cu", "nvcc", {
        "scatter_sort_bytes": (_ll, _ll, _i, ctypes.POINTER(ctypes.c_size_t)),
        "scatter_sort": (_p, _i, _ll, _ll, _i, _p, _p, _p, _p,
                         ctypes.c_size_t, _p),
        "scatter_plan": (_p, _ll, _ll, _i, _i, _i, _p, _p),
        "scatter_add_rows": (_p, _p, _p, _i, _p, _p, _p, _ll, _i, _ll, _i, _i,
                             _i, _p),
        "scatter_add_rows_buckets": (_p, _p, _p, _p, _p, _ll, _ll, _i, _i,
                                     _p)}),
    "fold_octa_cotangent": Library("fold_octa_cotangent.cu", "nvcc", {
        "fold_octa_cotangent": (_p, _p, _i, _i, _i, _i, _i, _p)}),
    "build_octa_table": Library("build_octa_table.cu", "nvcc", {
        "build_octa_table": (_p, _p, _i, _i, _i, _i, _i, _p)}),
    "lanczos_voxel_gather": Library("lanczos_voxel_gather.cu", "nvcc", {
        "lanczos_voxel_gather": (_p, _p, _p, _ll, _i, _i, _i, _i, _p, _p,
                                 _p)}),
    "adam_update": Library("adam_update.cu", "nvcc", {
        "adam_update_max_leaves": (),
        "adam_finite_reduce": (_i, _p, _p, _p, _f, _i, _p, _p),
        "adam_update_elementwise": (_i, _p, _p, _p, _p, _p, _p, _f, _i, _f,
                                    _f, _f, _f, _f, _p, _p, _p, _p)}),
    "softplus_grad_grad": Library("softplus_grad_grad.cu", "nvcc", {
        "softplus_grad_grad": (_i, _p, _p, _p, _p, _p, _ll, _ll, _ll, _f, _f,
                               _p)}),
    "gather_rows": Library("gather_rows.cu", "nvcc", {
        "gather_rows": (_p, _p, _i, _p, _ll, _ll, _ll, _i, _p)}),
    "ndjir_mesh": Library("marching_cubes.cpp", "g++", {
        "mc_run": (_pf, _i, _i, _i, _f, ctypes.POINTER(_pf),
                   ctypes.POINTER(_pi), ctypes.POINTER(_i64),
                   ctypes.POINTER(_i64)),
        "mc_free": (_p,),
        "mesh_connected_components": (_pi, _i64, _i64, _pi),
        "sample_triangles": (_pf, _pi, _i64, _i64, ctypes.c_uint64, _pf)},
        restypes={"mc_free": None, "sample_triangles": None}),
}

LAUNCHES: Dict[str, int] = {name: 0 for name, lib in LIBRARIES.items()
                            if lib.compiler == "nvcc"}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count(name: str, n: int = 1) -> None:
    """Add ``n`` launches of the CUDA kernel ``name`` to ``LAUNCHES``."""
    LAUNCHES[name] += n


def _compiler(kind: str) -> str:
    exe = shutil.which(kind) or _WHERE.get(kind, "")
    if not os.path.exists(exe):
        raise RuntimeError(f"{kind} not found: {_MISSING[kind]}")
    return exe


def library_path(name: str) -> str:
    lib = LIBRARIES[name]
    with open(os.path.join(_CSRC, lib.source), "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(_FLAGS[lib.compiler]).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: List[str] | None = None) -> Dict[str, str]:
    """Compile the named libraries (default: all) that are not built yet,
    one compiler process per source, all started together.  Returns each
    compiler's output (``nvcc``'s ``-Xptxas -v`` report: registers, spills,
    shared memory); raises if a compiler is missing or any build fails."""
    names = list(LIBRARIES) if names is None else names
    todo = {name: library_path(name) for name in names}
    todo = {name: out for name, out in todo.items() if not os.path.exists(out)}
    exes = {name: _compiler(LIBRARIES[name].compiler) for name in todo}
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        lib = LIBRARIES[name]
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [exes[name], *_FLAGS[lib.compiler], "-o", tmp,
               os.path.join(_CSRC, lib.source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} ({LIBRARIES[name].compiler} exit "
                          f"{proc.returncode}):\n{reports[name]}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("native build failed: " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The library, built first if needed, its functions bound."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        entry = LIBRARIES[name]
        for symbol, argtypes in entry.functions.items():
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = entry.restypes.get(symbol, ctypes.c_int)
        _LIBS[name] = lib
    return lib


def call(name: str, symbol: str, *args) -> None:
    """Call ``symbol`` of library ``name``, which returns a ``cudaError``;
    raise if it is not 0."""
    err = getattr(load(name), symbol)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: {symbol} failed: cudaError {err}")


def launch(name: str, symbol: str, device: torch.device, *args) -> None:
    """Launch ``symbol`` of kernel ``name`` on ``device``: ``args``, then
    the device's current stream, with the device current; raise if the
    ``cudaError`` it returns is not 0."""
    with torch.cuda.device(device):
        call(name, symbol, *args,
             torch.cuda.current_stream(device).cuda_stream)
