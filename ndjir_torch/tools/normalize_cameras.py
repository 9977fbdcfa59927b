"""IDR-style scene normalization: visual-hull scale_mat estimation (the
port's counterpart of ``ndjir_tpu/tools/normalize_cameras.py``).

Parity with reference scripts/preprocess_cameras.py:134-258: build a 100^3
candidate grid, count per-point mask observations across views, keep points
seen in >= min(n_views, 5) masks (the visual hull), then scale_mat = translate
to the hull centroid and scale by 3x the RMS radius so the object fits the
unit sphere.  Writes ``cameras_new.npz`` with the shared scale mat.

The hull is counted on a device in float64, the JAX package's precision:
the masks are read with the port's PNG reader and kept there as ``bool``
(49 masks of 1600x1200 take 94 MB), and every view's projection is one
pass over all grid points.  The projection is written out as elementwise
products and sums, so the CPU and a CUDA device round alike and count the
same hull.

Run: python -m ndjir_torch.tools.normalize_cameras --source_dir <scene_dir>
     [--device cuda|cpu]
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ndjir_torch.utils.png import read_png


def load_masks(masks_dir: str, device="cuda") -> torch.Tensor:
    """Every file of ``masks_dir`` in name order as one (n, H, W) ``bool``
    tensor on ``device``: a pixel is in the mask where its mean over the
    channels is above 127.5."""
    files = sorted(glob.glob(os.path.join(masks_dir, "*")))
    masks = None
    for i, f in enumerate(files):
        m = read_png(f)
        if m.ndim == 3:
            m = m.mean(axis=-1)
        m = torch.from_numpy(m > 127.5)
        if masks is None:
            masks = torch.empty((len(files),) + tuple(m.shape),
                                dtype=torch.bool, device=device)
        elif tuple(m.shape) != tuple(masks.shape[1:]):
            raise ValueError(f"{f} is {tuple(m.shape)}, the first mask "
                             f"{tuple(masks.shape[1:])}")
        masks[i] = m.to(device)
    if masks is None:
        raise ValueError(f"no mask files in {masks_dir}")
    return masks


def visual_hull(masks: torch.Tensor, Ps: np.ndarray, scale: float = 3.0,
                center=(0.0, 0.0, 0.0), grid_size: int = 100,
                min_views: int | None = None):
    """Count mask observations of a centered grid, on the device of the
    (n, H, W) ``bool`` masks; returns (centroid (3,) float64, normalization
    radius = 3 * RMS, the hull's (m, 3) float64 points on that device)."""
    device = masks.device
    n_cam, H, W = masks.shape
    min_views = min(min_views or 5, n_cam)
    lin = torch.from_numpy(np.linspace(-scale, scale, grid_size)).to(device)
    # np.meshgrid's default "xy" indexing: the point order of the reference
    xx, yy, zz = torch.meshgrid(lin, lin, lin, indexing="xy")
    c = np.asarray(center, np.float64)
    pts = torch.stack([xx.reshape(-1) + c[0], yy.reshape(-1) + c[1],
                       zz.reshape(-1) + c[2]])
    x, y, z = pts
    appears = torch.zeros(pts.shape[1], dtype=torch.int32, device=device)
    for i in range(n_cam):
        P = Ps[i].astype(np.float64)
        u, v, depth = (((P[r, 0] * x + P[r, 1] * y) + P[r, 2] * z) + P[r, 3]
                       for r in range(3))
        # half to even, as np.round; the bounds are checked on the rounded
        # floats, so a point behind the camera (depth <= 0: inf or nan) is
        # never cast to an integer
        u = torch.round(u / depth)
        v = torch.round(v / depth)
        ok = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (depth > 0)
        ui = torch.where(ok, u, 0).long()
        vi = torch.where(ok, v, 0).long()
        appears += (ok & masks[i][vi, ui]).int()
    hull = pts[:, appears >= min_views]
    if hull.shape[1] == 0:
        raise RuntimeError("Visual hull empty — check masks/cameras")
    centroid = hull.mean(dim=1)
    rms = torch.sqrt(((hull - centroid[:, None]) ** 2).sum(dim=0)).mean() * 3
    return centroid.cpu().numpy(), float(rms), hull.T


def normalize_cameras(scene_dir: str, grid_scale: float = 3.0,
                      device="cuda") -> str:
    cameras = np.load(os.path.join(scene_dir, "cameras.npz"))
    n = len([k for k in cameras.files if k.startswith("world_mat_")
             and "inv" not in k])
    Ps = np.stack([cameras[f"world_mat_{i}"][:3, :4] for i in range(n)])
    masks = load_masks(os.path.join(scene_dir, "mask"), device)

    centroid, radius, _ = visual_hull(masks, Ps, scale=grid_scale)
    norm = np.eye(4)
    norm[0, 0] = norm[1, 1] = norm[2, 2] = radius
    norm[:3, 3] = centroid

    out = {}
    for i in range(n):
        out[f"scale_mat_{i}"] = norm
        wm = np.eye(4, dtype=np.float32)
        wm[:3, :4] = Ps[i]
        out[f"world_mat_{i}"] = wm
    path = os.path.join(scene_dir, "cameras_new.npz")
    np.savez(path, **out)
    print(f"normalization:\n{norm}")
    return path


def main(argv=None):
    import argparse

    from ndjir_torch.cli import _device

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source_dir", required=True)
    p.add_argument("--grid_scale", type=float, default=3.0)
    p.add_argument("--replace", action="store_true",
                   help="overwrite cameras.npz instead of cameras_new.npz")
    p.add_argument("--device", default="cuda",
                   help="device of the hull count (default cuda; cpu runs "
                   "it on the host)")
    args = p.parse_args(argv)
    path = normalize_cameras(args.source_dir, args.grid_scale, _device(args))
    if args.replace:
        os.replace(path, os.path.join(args.source_dir, "cameras.npz"))


if __name__ == "__main__":
    main()
