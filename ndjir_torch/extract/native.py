"""ctypes bindings for the port's native mesh library
(``ndjir_torch/csrc/marching_cubes.cpp``, the port's copy of the JAX
package's ``csrc/marching_cubes.cpp``).

The library is compiled with ``g++`` into ``ndjir_torch/csrc/build/``
(listed in ``.gitignore``) the first time it is needed, never when this
module is imported; the file name carries the hash of the source and the
flags, so a changed source is rebuilt.  The flags are those of the JAX
package's ``csrc/Makefile``, so both libraries compile the same code the
same way.  A failed build raises: there is no numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Tuple

import numpy as np

from ndjir_torch.kernels import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "marching_cubes.cpp")
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native", "-shared"]
_lib = None


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libndjir_mesh-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is not built yet; returns its path.
    Raises if ``g++`` is missing or fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native mesh library is built "
                           "with g++")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *_FLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native mesh library build failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return out


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.mc_run.restype = ctypes.c_int
    lib.mc_run.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mc_free.argtypes = [ctypes.c_void_p]
    lib.mc_free.restype = None
    lib.mesh_connected_components.restype = ctypes.c_int
    lib.mesh_connected_components.argtypes = [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int)]
    lib.sample_triangles.restype = None
    lib.sample_triangles.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return lib


def marching_cubes(field: np.ndarray, level: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """field (Gx, Gy, Gz) float32 -> (verts (V, 3) in voxel coords,
    tris (T, 3) int32)."""
    lib = get_lib()
    field = np.ascontiguousarray(field, np.float32)
    gx, gy, gz = field.shape
    pv = ctypes.POINTER(ctypes.c_float)()
    pt = ctypes.POINTER(ctypes.c_int)()
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    rc = lib.mc_run(field.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    gx, gy, gz, ctypes.c_float(level),
                    ctypes.byref(pv), ctypes.byref(pt),
                    ctypes.byref(nv), ctypes.byref(nt))
    if rc != 0:
        raise RuntimeError("mc_run failed (allocation)")
    try:
        verts = np.ctypeslib.as_array(pv, shape=(nv.value, 3)).copy() \
            if nv.value else np.zeros((0, 3), np.float32)
        tris = np.ctypeslib.as_array(pt, shape=(nt.value, 3)).copy() \
            if nt.value else np.zeros((0, 3), np.int32)
    finally:
        lib.mc_free(pv)
        lib.mc_free(pt)
    return verts, tris


def connected_components(tris: np.ndarray, n_vertices: int) -> np.ndarray:
    """Per-triangle component labels (vertex connectivity)."""
    lib = get_lib()
    tris = np.ascontiguousarray(tris, np.int32)
    labels = np.zeros((len(tris),), np.int32)
    lib.mesh_connected_components(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(tris),
        n_vertices, labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return labels


def sample_surface(verts: np.ndarray, tris: np.ndarray, n_samples: int,
                   seed: int = 0) -> np.ndarray:
    """Area-weighted uniform samples on the mesh surface, (n, 3) float32
    (the library's ``sample_triangles``, the JAX package's generator and
    seed)."""
    lib = get_lib()
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    out = np.zeros((n_samples, 3), np.float32)
    lib.sample_triangles(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        len(tris), n_samples, seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
