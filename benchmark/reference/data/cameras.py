"""Camera math: projection decomposition and ray generation (the port's copy
of ``ndjir_tpu/data/cameras.py``, numpy only).

Parity with reference python/helper.py:27-81 (which uses
cv2.decomposeProjectionMatrix); here the decomposition is a scipy RQ
factorization with positive-diagonal normalization plus the SVD null-space
camera center — identical output, no cv2 dependency.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.linalg


def load_K_Rt_from_P(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Decompose a 3x4 projection P = K [R | t].

    Returns (intrinsic 4x4 with K normalized by K[2,2], pose 4x4 =
    [R_c2w | camera_center]) matching reference helper.py:27-41 /
    cv2.decomposeProjectionMatrix semantics.
    """
    M = P[:3, :3]
    K, R = scipy.linalg.rq(M)
    # positive diagonal of K (cv2 convention)
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1.0
    S = np.diag(signs)
    K = K @ S
    R = S @ R
    if np.linalg.det(R) < 0:  # keep R a proper rotation
        K = -K
        R = -R

    # camera center: right null vector of P (homogeneous)
    _, _, Vt = np.linalg.svd(P)
    c = Vt[-1]
    c = c[:3] / c[3]

    K = K / K[2, 2]
    intrinsic = np.eye(4)
    intrinsic[:3, :3] = K

    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T          # world-to-camera transposed = camera-to-world
    pose[:3, 3] = c
    return intrinsic, pose


def generate_raydir_camloc(pose: np.ndarray, intrinsic: np.ndarray,
                           xy: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel coords -> unit world ray directions + camera locations.

    pose (B, 4, 4); intrinsic (B, 3, 3); xy (B, R, 2) pixel coords (no +0.5
    half-pixel shift — reference convention, helper.py:44-73).
    """
    B, R, _ = xy.shape
    R_c2w = pose[:, np.newaxis, :3, :3]
    camloc = pose[:, np.newaxis, :3, 3:4]
    K_inv = np.linalg.inv(intrinsic[:, np.newaxis, :, :])

    z = np.ones([B, R, 1])
    xyz_pixel = np.concatenate([xy, z], axis=-1)[:, :, :, np.newaxis]
    xyz_camera = np.matmul(K_inv, xyz_pixel)
    xyz_world = np.matmul(R_c2w, xyz_camera).reshape(B, R, 3)
    raydir = xyz_world / np.sqrt(
        np.sum(xyz_world ** 2, axis=-1, keepdims=True))
    return raydir.astype(np.float32), camloc.reshape(B, 3).astype(np.float32)


def generate_all_pixels(W: int, H: int) -> np.ndarray:
    """Row-major (x, y) pixel grid, shape (H*W, 2)
    (reference helper.py:76-81)."""
    xx, yy = np.meshgrid(np.arange(W), np.arange(H))
    return np.asarray([xx.flatten(), yy.flatten()]).T
