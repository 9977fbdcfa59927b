"""Offscreen mesh views and camera export (the port's counterpart of
``ndjir_tpu/tools/viewers.py``).

Replaces the reference's open3d viewers (scripts/viewer.py, viewer_pbr.py,
render_pbr_meshes_with_camera_params.py, create_o3d_camera_parameters.py)
with dependency-free offscreen renders of vertex-colored meshes: one view,
a turntable image sequence, views from a scene's cameras, and the cameras
as portable JSON.

The JAX package paints the faces far to near with matplotlib's Agg
rasterizer.  The card's machine has no matplotlib, so the port computes
the same visibility on a device: every pixel centre shows the covering
face that a painter draws last (the least mean camera depth, equal depths
in face order), found with one ``scatter_reduce`` over the (face, pixel)
candidates of each face's pixel bounding box.  Agg also antialiases every
edge, blending a covered pixel with what lies under it, so the images
agree with the JAX package's on the silhouette and the faces, not on the
edges' blended pixels.

The GIF writer (imageio), the camera-pose plot and the attribute histogram
(matplotlib) are not ported: the card's machine has neither library.

Run: python -m ndjir_torch.tools.viewers <mesh|turntable|render-views|
     export-cameras> ...  (the views take --device cuda|cpu)
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ndjir_torch.utils.mesh_io import load_obj
from ndjir_torch.utils.png import write_png

# candidates ((face, pixel) pairs) tested at once; at least a whole image,
# the most one face can cover
CANDIDATES = 1 << 22
# a face's pixel bounding box is widened by this many pixels, more than
# the rounding of the pixel mapping and of the edge test at any camera
# coordinate below ~1e9
_MARGIN_PX = 1e-3


def _look_at_rotation(eye: np.ndarray, target=None) -> np.ndarray:
    target = np.zeros(3) if target is None else target
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    if abs(fwd @ up) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd])


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` correctly rounded on every device: PyTorch's CUDA kernel
    multiplies by the reciprocal of a Python-number divisor, so the
    divisor is made a tensor."""
    return a / torch.full_like(a, b)


def _face_colors_u8(verts: torch.Tensor, faces: torch.Tensor, colors,
                   R: np.ndarray) -> torch.Tensor:
    """(nf, 3) uint8 colour of each face: the mean of its vertex colours
    (float32), or without colours headlight shading 0.8 |n . fwd| + 0.1 of
    its unit normal (float32) against the view direction (float64); each
    clipped to [0, 1] and rounded to 8 bits as Agg rounds a colour,
    floor(255 v + 1/2)."""
    if colors is not None:
        c = colors[faces]
        fc = _div(c[:, 0] + c[:, 1] + c[:, 2], 3).double()
    else:
        v0, v1, v2 = (verts[faces[:, k]] for k in range(3))
        a, b = v1 - v0, v2 - v0
        nrm = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                           a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                           a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)
        norm = torch.sqrt(nrm[:, 0] * nrm[:, 0] + nrm[:, 1] * nrm[:, 1]
                          + nrm[:, 2] * nrm[:, 2])
        nrm = (nrm / torch.clamp(norm, min=1e-12)[:, None]).double()
        fwd = R[2]
        lam = torch.abs(nrm[:, 0] * fwd[0] + nrm[:, 1] * fwd[1]
                        + nrm[:, 2] * fwd[2])
        fc = (lam * 0.8 + 0.1)[:, None].expand(-1, 3)
    return torch.floor(torch.clamp(fc, 0, 1) * 255 + 0.5).to(torch.uint8)


def render_mesh_view(verts, faces, colors, eye, res=512, fov=45.0,
                     device="cuda"):
    """Visibility of a painter's algorithm at the pixel centres, on
    ``device`` -> (res, res, 3) uint8, white where no face lies, the image
    spanning [-1, 1]^2 with y up."""
    eye = np.asarray(eye, float)
    R = _look_at_rotation(eye)
    V = torch.from_numpy(np.asarray(verts, np.float32)).to(device)
    Fc = torch.from_numpy(np.asarray(faces, np.int64)).to(device)
    C = None if colors is None else \
        torch.from_numpy(np.asarray(colors, np.float32)).to(device)
    nf = len(Fc)

    # camera coordinates (x right, y down, z forward) in float64, as
    # (verts - eye) @ R.T with its products summed in order
    d = [V[:, k].double() - eye[k] for k in range(3)]
    cam = [(d[0] * R[k, 0] + d[1] * R[k, 1]) + d[2] * R[k, 2]
           for k in range(3)]
    f = 1.0 / np.tan(np.radians(fov) / 2)
    z = torch.clamp(cam[2], min=1e-6)
    x = f * cam[0] / z
    y = -f * cam[1] / z

    # far to near, equal depths in face order: a face's place in the
    # painter's sequence; the last one drawn at a pixel shows
    zf = cam[2][Fc]
    tz = _div(zf[:, 0] + zf[:, 1] + zf[:, 2], 3)
    order = torch.sort(-tz, stable=True).indices
    place = torch.empty(nf, dtype=torch.int64, device=device)
    place[order] = torch.arange(nf, device=device)
    fc8 = _face_colors_u8(V, Fc, C, R)

    xs, ys = x[Fc], y[Fc]                       # (nf, 3) screen corners
    area = ((xs[:, 1] - xs[:, 0]) * (ys[:, 2] - ys[:, 0])
            - (ys[:, 1] - ys[:, 0]) * (xs[:, 2] - xs[:, 0]))
    ok = torch.isfinite(area) & (area != 0)
    sign = torch.sign(area)
    # pixel bounding boxes, widened by _MARGIN_PX: column j's centre is
    # x = (2j + 1) / res - 1, row i's is y = 1 - (2i + 1) / res
    half = res / 2
    xmin, xmax = xs.min(1).values, xs.max(1).values
    ymin, ymax = ys.min(1).values, ys.max(1).values
    j0 = torch.clamp(torch.ceil((xmin + 1) * half - 0.5 - _MARGIN_PX), 0, res)
    j1 = torch.clamp(torch.floor((xmax + 1) * half - 0.5 + _MARGIN_PX), -1,
                     res - 1)
    i0 = torch.clamp(torch.ceil((1 - ymax) * half - 0.5 - _MARGIN_PX), 0, res)
    i1 = torch.clamp(torch.floor((1 - ymin) * half - 0.5 + _MARGIN_PX), -1,
                     res - 1)
    bw = torch.where(ok, torch.clamp(j1 - j0 + 1, min=0), 0).long()
    bh = torch.where(ok, torch.clamp(i1 - i0 + 1, min=0), 0).long()
    j0 = torch.where(ok, j0, 0).long()
    i0 = torch.where(ok, i0, 0).long()
    counts = bw * bh
    cum = torch.cumsum(counts, 0).cpu().numpy()

    best = torch.full((res * res,), -1, dtype=torch.int64, device=device)
    cap = max(CANDIDATES, res * res)
    start = 0
    while start < nf:
        done = cum[start - 1] if start else 0
        stop = max(int(np.searchsorted(cum, done + cap, side="right")),
                   start + 1)
        total = int(cum[stop - 1] - done)
        if total:
            n = counts[start:stop]
            face = torch.repeat_interleave(
                torch.arange(start, stop, device=device), n,
                output_size=total)
            first = torch.cumsum(n, 0) - n
            local = (torch.arange(total, device=device)
                     - first[face - start])
            w = bw[face]
            di = local // w
            j = j0[face] + (local - di * w)
            i = i0[face] + di
            cx = _div((2 * j + 1).double(), res) - 1
            cy = 1 - _div((2 * i + 1).double(), res)
            px, py = xs[face], ys[face]
            s = sign[face]
            inside = torch.ones(total, dtype=torch.bool, device=device)
            for a, b in ((0, 1), (1, 2), (2, 0)):
                e = ((px[:, b] - px[:, a]) * (cy - py[:, a])
                     - (py[:, b] - py[:, a]) * (cx - px[:, a]))
                inside &= e * s >= 0
            best.scatter_reduce_(0, (i * res + j)[inside],
                                 place[face][inside], "amax")
        start = stop

    img = torch.full((res * res, 3), 255, dtype=torch.uint8, device=device)
    hit = best >= 0
    img[hit] = fc8[order[best[hit]]]
    return img.view(res, res, 3).cpu().numpy()


def view_mesh(fpath: str, out_path: str | None = None, res=512,
              cam_dist=2.0, device="cuda"):
    V, F, C = load_obj(fpath)
    center = V.mean(axis=0)
    Vc = V - center
    scale = np.abs(Vc).max()
    img = render_mesh_view(Vc / scale, F, C,
                           eye=np.array([1.2, -1.2, 0.8]) * cam_dist / 1.9,
                           res=res, device=device)
    out_path = out_path or os.path.splitext(fpath)[0] + "_view.png"
    write_png(out_path, img)
    return out_path


def turntable(fpath: str, out_dir: str | None = None, n_views=60, res=512,
              cam_dist=2.0, elevation=0.5, device="cuda"):
    """Orbit image sequence (reference viewer_pbr.py camera-path videos)."""
    V, F, C = load_obj(fpath)
    center = V.mean(axis=0)
    Vc = (V - center)
    Vc = Vc / np.abs(Vc).max()
    out_dir = out_dir or os.path.splitext(fpath)[0] + "_turntable"
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n_views):
        th = 2 * np.pi * i / n_views
        eye = cam_dist * np.array(
            [np.cos(th), np.sin(th), elevation]) / np.sqrt(1 + elevation ** 2)
        img = render_mesh_view(Vc, F, C, eye, res=res, device=device)
        write_png(os.path.join(out_dir, f"{i:04d}.png"), img)
    return out_dir


def _camera_count(cams) -> int:
    return len([k for k in cams.files if k.startswith("world_mat_")
                and "inv" not in k])


def _pose(cams, i: int):
    """(intrinsic, pose) of view ``i``: world_mat_i @ scale_mat_i
    decomposed."""
    from ndjir_torch.data.cameras import load_K_Rt_from_P

    S = cams[f"scale_mat_{i}"] if f"scale_mat_{i}" in cams.files \
        else np.eye(4)
    return load_K_Rt_from_P((cams[f"world_mat_{i}"] @ S)[:3])


def render_with_camera_params(mesh_path: str, cameras_npz: str,
                              out_dir: str | None = None, res=512,
                              indices=None, device="cuda"):
    """Offscreen renders of a mesh from dataset camera poses (reference:
    render_pbr_meshes_with_camera_params.py)."""
    V, F, C = load_obj(mesh_path)
    cams = np.load(cameras_npz)
    out_dir = out_dir or os.path.splitext(mesh_path)[0] + "_views"
    os.makedirs(out_dir, exist_ok=True)
    idxs = indices if indices is not None else range(_camera_count(cams))
    outs = []
    for i in idxs:
        _, pose = _pose(cams, i)
        img = render_mesh_view(V, F, C, pose[:3, 3], res=res, device=device)
        p = os.path.join(out_dir, f"{i:06d}.png")
        write_png(p, img)
        outs.append(p)
    return outs


def export_cameras_json(cameras_npz: str, out_path: str | None = None):
    """cameras.npz -> portable JSON (per-view K, R_c2w, camera center);
    generic replacement for the reference's O3D-specific exporter
    (create_o3d_camera_parameters.py)."""
    import json

    cams = np.load(cameras_npz)
    out = []
    for i in range(_camera_count(cams)):
        intrinsic, pose = _pose(cams, i)
        out.append(dict(index=i,
                        K=intrinsic[:3, :3].tolist(),
                        R_c2w=pose[:3, :3].tolist(),
                        center=pose[:3, 3].tolist()))
    out_path = out_path or os.path.splitext(cameras_npz)[0] + "_cameras.json"
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    return out_path


def main(argv=None):
    import argparse

    from ndjir_torch.cli import _device

    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("mesh")
    v.add_argument("mesh")
    v.add_argument("--out")
    t = sub.add_parser("turntable")
    t.add_argument("mesh")
    t.add_argument("--views", type=int, default=60)
    cr = sub.add_parser("render-views")
    cr.add_argument("mesh")
    cr.add_argument("npz")
    for view in (v, t, cr):
        view.add_argument("--device", default="cuda",
                          help="device of the views (default cuda; cpu "
                          "renders on the host)")
    ej = sub.add_parser("export-cameras")
    ej.add_argument("npz")
    args = p.parse_args(argv)
    if args.cmd == "mesh":
        print(view_mesh(args.mesh, args.out, device=_device(args)))
    elif args.cmd == "turntable":
        print(turntable(args.mesh, n_views=args.views,
                        device=_device(args)))
    elif args.cmd == "render-views":
        print(render_with_camera_params(args.mesh, args.npz,
                                        device=_device(args)))
    elif args.cmd == "export-cameras":
        print(export_cameras_json(args.npz))


if __name__ == "__main__":
    main()
