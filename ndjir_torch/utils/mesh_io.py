"""Minimal mesh IO: OBJ and PLY writers with per-vertex colors (the port's
copy of ``ndjir_tpu/utils/mesh_io.py``).

Replaces the reference's trimesh export dependency (reference:
extract_by_mc.py:197-223 exports per-attribute OBJ meshes with vertex
colors; evaluate_chamfer writes colored PLY point clouds).  DCC tools
(Blender, MeshLab) read the ``v x y z r g b`` OBJ vertex-color extension.
The files are the JAX package's, byte for byte: each OBJ number goes
through the same ``%.6f`` / ``%d`` formatting, and each PLY record is the
same packed little-endian struct, here made for whole arrays at once.
"""

from __future__ import annotations

import warnings

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


# bytes that may stand in an OBJ file the fast reader takes: printable ASCII
# and the newline; a number's characters
_PLAIN = bytes(range(32, 127)) + b"\n"
_FLOAT = b"0123456789.eE+- "
_INT = b"0123456789- "


def _number_rows(rows, dtype, chars: bytes):
    """The numbers of ``rows`` (bytes, the tokens after an OBJ keyword) as
    an (n, k) array, or None unless every row holds k tokens of ``chars``
    separated by one space each and numpy reads them all."""
    text = b" ".join(rows)
    if not rows or text.translate(None, chars) or b"  " in text \
            or text[:1] == b" " or text[-1:] == b" ":
        return None
    counts = {r.count(b" ") for r in rows}
    if len(counts) != 1:
        return None
    k = counts.pop() + 1
    with warnings.catch_warnings():
        # numpy warns where it stops short of the end (a malformed number)
        warnings.simplefilter("error", DeprecationWarning)
        try:
            a = np.fromstring(text, dtype=dtype, sep=" ")
        except (ValueError, DeprecationWarning):
            return None
    return a.reshape(len(rows), k) if a.size == len(rows) * k else None


def _load_obj_plain(data: bytes):
    """:func:`load_obj` of a file in the layout :func:`save_obj` writes
    (``v`` and ``f`` lines of single-space-separated numbers, every ``v``
    line with as many as the others, plain integer face indices), or None
    for any other file.  Python's ``float`` and numpy's text reader both
    round a decimal correctly, so the arrays are the per-line reader's."""
    if not data.isascii() or data.translate(None, _PLAIN):
        return None
    lines = data.split(b"\n")
    v = [ln[2:] for ln in lines if ln[:2] == b"v "]
    f = [ln[2:] for ln in lines if ln[:2] == b"f "]
    for ln in lines:
        if ln[:2] not in (b"v ", b"f "):
            t = ln.split(None, 1)
            if t and t[0] in (b"v", b"f"):
                return None
    vs = _number_rows(v, np.float64, _FLOAT)
    fs = _number_rows(f, np.int64, _INT)
    if vs is None or fs is None or vs.shape[1] < 3 or fs.shape[1] < 3:
        return None
    C = vs[:, 3:6].astype(np.float32) if vs.shape[1] >= 6 else None
    return vs[:, :3].astype(np.float32), fs[:, :3] - 1, C


def load_obj(path: str):
    """Reads v/f lines (with optional vertex colors).  Returns
    (V, F, C|None).  A file in :func:`save_obj`'s layout is read at once
    (a 512^3 extraction's mesh in seconds, not a minute); any other line by
    line."""
    with open(path, "rb") as fp:
        plain = _load_obj_plain(fp.read())
    if plain is not None:
        return plain
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


_XYZ = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
_XYZ_RGB = _XYZ + [("red", "u1"), ("green", "u1"), ("blue", "u1")]


def _ply_header(n_verts: int, colored: bool, n_faces=None) -> bytes:
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n_verts}",
              "property float x", "property float y", "property float z"]
    if colored:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    if n_faces is not None:
        header += [f"element face {n_faces}",
                   "property list uchar int vertex_indices"]
    header += ["end_header"]
    return ("\n".join(header) + "\n").encode()


def _ply_vertices(v: np.ndarray, c8: np.ndarray | None) -> bytes:
    """Packed little-endian records: x y z as float32, then r g b as uint8
    when ``c8`` is given."""
    rec = np.empty(len(v), np.dtype(_XYZ_RGB if c8 is not None else _XYZ))
    rec["x"], rec["y"], rec["z"] = v[:, 0], v[:, 1], v[:, 2]
    if c8 is not None:
        rec["red"], rec["green"], rec["blue"] = c8[:, 0], c8[:, 1], c8[:, 2]
    return rec.tobytes()


def save_ply_points(path: str, points: np.ndarray,
                    colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY point cloud, optionally with uint8 colors
    (the bytes of ``ndjir_tpu/utils/mesh_io.py``'s writer)."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    c8 = None
    if colors is not None:
        c8 = (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint8)
    with open(path, "wb") as fp:
        fp.write(_ply_header(len(pts), c8 is not None))
        fp.write(_ply_vertices(pts, c8))


def save_ply_mesh(path: str, vertices: np.ndarray, faces: np.ndarray,
                  vertex_colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY mesh, optionally with uint8 vertex colors
    (the bytes of ``ndjir_tpu/utils/mesh_io.py``'s writer)."""
    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    f = np.asarray(faces, np.int32).reshape(-1, 3)
    c8 = None
    if vertex_colors is not None:
        c8 = (np.clip(np.asarray(vertex_colors), 0, 1) * 255).astype(np.uint8)
        if c8.shape[-1] == 1:
            c8 = np.repeat(c8, 3, axis=-1)
    tri = np.empty(len(f), np.dtype([("n", "u1"), ("a", "<i4"),
                                     ("b", "<i4"), ("c", "<i4")]))
    tri["n"] = 3
    tri["a"], tri["b"], tri["c"] = f[:, 0], f[:, 1], f[:, 2]
    with open(path, "wb") as fp:
        fp.write(_ply_header(len(v), c8 is not None, len(f)))
        fp.write(_ply_vertices(v, c8))
        fp.write(tri.tobytes())
