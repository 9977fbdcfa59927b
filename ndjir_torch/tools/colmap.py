"""COLMAP text-model -> IDR cameras.npz conversion (the port's copy of
``ndjir_tpu/tools/colmap.py``: host text parsing and 3x3 algebra in numpy
float64, as there).

Parity with reference scripts/convert_colmap_to_npz.py:30-203: reads
sparse/0/{cameras.txt,images.txt}, rebuilds ``world_mat_i = K [R | t]``
(w2c, OpenCV convention so load_K_Rt_from_P round-trips), writes identity
scale mats, and deletes image/mask files for views COLMAP dropped.

Run: python -m ndjir_torch.tools.colmap -i <scene_dir>
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np

_PINHOLE_MODELS = ("RADIAL", "SIMPLE_RADIAL", "SIMPLE_PINHOLE", "PINHOLE")


def read_cameras(fpath: str):
    cams = {}
    with open(fpath) as fp:
        for line in fp:
            if line.startswith("#") or not line.strip():
                continue
            d = line.split()
            model = d[1]
            if model not in _PINHOLE_MODELS:
                raise ValueError(
                    f"Unsupported COLMAP camera model {model}; use one of "
                    f"{_PINHOLE_MODELS}")
            cam_id = int(d[0])
            fx = float(d[4])
            if model.startswith("SIMPLE"):
                fy, cx, cy = fx, float(d[5]), float(d[6])
            else:
                fy, cx, cy = float(d[5]), float(d[6]), float(d[7])
            cams[cam_id] = (fx, fy, cx, cy)
    return cams


def read_images(fpath: str):
    """images.txt: alternating pose lines / 2D-point lines."""
    out = []
    with open(fpath) as fp:
        pose_line = True
        for line in fp:
            if line.startswith("#") or not line.strip():
                continue
            if pose_line:
                d = line.split()
                out.append(dict(
                    image_id=int(d[0]),
                    quat=np.asarray([float(x) for x in d[1:5]]),
                    trans=np.asarray([float(x) for x in d[5:8]]),
                    camera_id=int(d[8]),
                    name=d[9]))
            pose_line = not pose_line
    return out


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    """Hamilton-convention quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def convert_colmap_to_npz(scene_dir: str, remove_dropped: bool = True
                          ) -> Dict[str, np.ndarray]:
    base = os.path.join(scene_dir, "sparse", "0")
    cams = read_cameras(os.path.join(base, "cameras.txt"))
    images = read_images(os.path.join(base, "images.txt"))

    params: Dict[str, np.ndarray] = {}
    for o, img in enumerate(sorted(images, key=lambda im: im["name"])):
        R = qvec2rotmat(img["quat"])          # w2c rotation
        t = img["trans"].reshape(3, 1)        # w2c translation
        fx, fy, cx, cy = cams[img["camera_id"]] if img["camera_id"] in cams \
            else next(iter(cams.values()))
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        wm = np.eye(4)
        wm[:3, :3] = K @ R
        wm[:3, 3] = (K @ t)[:, 0]
        params[f"world_mat_{o}"] = wm
        params[f"scale_mat_{o}"] = np.eye(4)

    np.savez(os.path.join(scene_dir, "cameras.npz"), **params)

    if remove_dropped:
        image_paths = sorted(glob.glob(os.path.join(scene_dir, "image", "*")))
        mask_paths = sorted(glob.glob(os.path.join(scene_dir, "mask", "*")))
        for i, (ip, mp) in enumerate(zip(image_paths, mask_paths)):
            if f"world_mat_{i}" in params:
                continue
            print(f"COLMAP dropped view {i}: removing {ip}, {mp}")
            os.remove(ip)
            os.remove(mp)
    return params


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--ipath", required=True)
    args = p.parse_args()
    convert_colmap_to_npz(args.ipath)
    print("Wrote cameras.npz")


if __name__ == "__main__":
    main()
