"""Minimal OBJ mesh IO with per-vertex colors (the port's copy of
``save_obj`` / ``load_obj`` in ``ndjir_tpu/utils/mesh_io.py``).

Replaces the reference's trimesh export dependency (reference:
extract_by_mc.py:197-223 exports per-attribute OBJ meshes with vertex
colors).  DCC tools (Blender, MeshLab) read the ``v x y z r g b`` OBJ
vertex-color extension.  The text is the JAX package's, character for
character: each number goes through the same ``%.6f`` / ``%d`` formatting,
here applied to whole arrays at once.
"""

from __future__ import annotations

import numpy as np


def _lines(fmt: str, rows: np.ndarray) -> str:
    """``fmt`` (one line, with newline) applied to every row of ``rows``."""
    if len(rows) == 0:
        return ""
    return (fmt * len(rows)) % tuple(rows.ravel().tolist())


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray,
             vertex_colors: np.ndarray | None = None) -> None:
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    if vertex_colors is not None:
        c = np.clip(np.asarray(vertex_colors, np.float32), 0.0, 1.0)
        if c.shape[-1] == 1:
            c = np.repeat(c, 3, axis=-1)
        text = _lines("v %.6f %.6f %.6f %.6f %.6f %.6f\n",
                      np.concatenate([v.reshape(-1, 3),
                                      c.reshape(-1, 3)], axis=1))
    else:
        text = _lines("v %.6f %.6f %.6f\n", v.reshape(-1, 3))
    text += _lines("f %d %d %d\n", f.reshape(-1, 3) + 1)  # OBJ is 1-indexed
    with open(path, "w") as fp:
        fp.write(text if text else "\n")


def load_obj(path: str):
    """Reads v/f lines (with optional vertex colors).  Returns
    (V, F, C|None)."""
    verts, faces, colors = [], [], []
    with open(path) as fp:
        for line in fp:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(x) for x in t[1:4]])
                if len(t) >= 7:
                    colors.append([float(x) for x in t[4:7]])
            elif t[0] == "f":
                faces.append([int(x.split("/")[0]) - 1 for x in t[1:4]])
    V = np.asarray(verts, np.float32)
    F = np.asarray(faces, np.int64)
    C = np.asarray(colors, np.float32) if colors else None
    return V, F, C
