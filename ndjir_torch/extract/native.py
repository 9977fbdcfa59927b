"""ctypes bindings for the port's native mesh library
(``ndjir_torch/csrc/marching_cubes.cpp``, the port's copy of the JAX
package's ``csrc/marching_cubes.cpp``).

:mod:`ndjir_torch.kernels` builds, loads and binds it (``ndjir_mesh``) as
it does the CUDA kernels: with ``g++`` and the flags of the JAX package's
``csrc/Makefile``, so both libraries compile the same code the same way,
the first time it is needed, never when this module is imported.  A failed
build raises: there is no numpy fallback.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ndjir_torch import kernels


def marching_cubes(field: np.ndarray, level: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """field (Gx, Gy, Gz) float32 -> (verts (V, 3) in voxel coords,
    tris (T, 3) int32)."""
    lib = kernels.load("ndjir_mesh")
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
    lib = kernels.load("ndjir_mesh")
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
    lib = kernels.load("ndjir_mesh")
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    out = np.zeros((n_samples, 3), np.float32)
    lib.sample_triangles(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        len(tris), n_samples, seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
