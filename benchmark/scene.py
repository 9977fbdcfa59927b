"""The scenes the benchmark trains on and renders: multi-view captures of
an analytic object made on the device from a seed, in the IDR layout the
port's dataset reads (``world_mat_i`` / ``scale_mat_i`` cameras, uint8
images and masks).  One general generator reads a traffic file's
``scene`` parameters:

- ``views``, ``width``, ``height``: the capture (DTU: 49 views of
  1600x1200);
- ``focal_px``: the pinhole's focal length in pixels, the principal point
  at the image centre;
- ``distance``, ``elevation_deg``: each camera's distance from the origin
  and elevation, drawn uniformly from the two ranges, at azimuths evenly
  spread around the object with a jitter of half a step, looking at a
  point drawn within ``aim`` of the origin;
- ``radius``: the range the object's three semi-axes are drawn from (an
  ellipsoid inside the unit sphere, so that the mask covers part of each
  view, as the mask of a real capture does).

The content does not change the work of a step or a view (the samples
per ray are fixed); it keeps the losses in the range of a real scan.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def _uniform(gen: torch.Generator, lo: float, hi: float, n: int,
             device) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    return lo + (hi - lo) * u


def cameras(scene: Dict, gen: torch.Generator, device
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K (3, 3), world-to-camera [R | t] (n, 3, 4)), float64 on
    ``device``: OpenCV axes (x right, y down, z forward), world up +z."""
    n = int(scene["views"])
    f = float(scene["focal_px"])
    K = torch.tensor([[f, 0.0, scene["width"] / 2.0],
                      [0.0, f, scene["height"] / 2.0],
                      [0.0, 0.0, 1.0]], dtype=torch.float64, device=device)
    step = 2 * math.pi / n
    az = torch.arange(n, dtype=torch.float64, device=device) * step \
        + _uniform(gen, -0.5 * step, 0.5 * step, n, device)
    el = torch.deg2rad(_uniform(gen, *scene["elevation_deg"], n, device))
    dist = _uniform(gen, *scene["distance"], n, device)
    eye = dist[:, None] * torch.stack([torch.cos(el) * torch.cos(az),
                                       torch.cos(el) * torch.sin(az),
                                       torch.sin(el)], dim=-1)
    aim = _uniform(gen, -scene["aim"], scene["aim"], 3 * n,
                   device).reshape(n, 3)
    fwd = torch.nn.functional.normalize(aim - eye, dim=-1)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64, device=device)
    right = torch.nn.functional.normalize(
        torch.linalg.cross(fwd, up.expand_as(fwd)), dim=-1)
    down = torch.linalg.cross(fwd, right)
    r_w2c = torch.stack([right, down, fwd], dim=1)     # rows
    t = -(r_w2c @ eye[:, :, None])
    return K, torch.cat([r_w2c, t], dim=2)


def camera_arrays(K: torch.Tensor, rt: torch.Tensor) -> Dict[str, np.ndarray]:
    """The IDR ``cameras.npz`` entries: world_mat = K [R | t], scale_mat
    the identity (the scene is already inside the unit sphere)."""
    K4 = torch.eye(4, dtype=torch.float64, device=K.device)
    K4[:3, :3] = K
    out = {}
    for i, m in enumerate(rt.cpu().numpy()):
        w = np.eye(4)
        w[:3, :4] = m
        out[f"world_mat_{i}"] = (K4.cpu().numpy() @ w).astype(np.float32)
        out[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
    return out


def make_scene(scene: Dict, seed: int, device
               ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
    """(images (n, H, W, 3) uint8, masks (n, H, W) uint8, cameras) on the
    host, rendered on ``device`` one view at a time."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    K, rt = cameras(scene, gen, device)
    H, W = int(scene["height"]), int(scene["width"])
    axes = _uniform(gen, *scene["radius"], 3, device)
    light = torch.nn.functional.normalize(
        _uniform(gen, -1.0, 1.0, 3, device) + torch.tensor(
            [0.0, 0.0, 1.5], dtype=torch.float64, device=device), dim=0)
    freq = _uniform(gen, 6.0, 14.0, 9, device).reshape(3, 3)
    phase = _uniform(gen, 0.0, 2 * math.pi, 3, device)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64,
                                         device=device),
                            torch.arange(W, dtype=torch.float64,
                                         device=device), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)
    cam_dirs = pix @ torch.linalg.inv(K).t()
    images = torch.empty((len(rt), H, W, 3), dtype=torch.uint8,
                         device=device)
    masks = torch.empty((len(rt), H, W), dtype=torch.uint8, device=device)
    for i, m in enumerate(rt):
        r_w2c, t = m[:, :3], m[:, 3]
        eye = -(r_w2c.t() @ t)
        d = torch.nn.functional.normalize(cam_dirs @ r_w2c, dim=-1)
        # ray-ellipsoid: |(eye + s d) / axes| = 1
        e, dd = eye / axes, d / axes
        a = (dd * dd).sum(-1)
        b = 2 * (dd * e).sum(-1)
        c = (e * e).sum() - 1.0
        disc = b * b - 4 * a * c
        hit = disc > 0
        s = (-b - torch.sqrt(disc.clamp_min(0))) / (2 * a)
        x = eye + s[:, None] * d
        normal = torch.nn.functional.normalize(x / axes ** 2, dim=-1)
        albedo = 0.55 + 0.4 * torch.sin(x @ freq.t() + phase)
        shade = 0.2 + 0.8 * (normal @ light).clamp_min(0)
        bg = 0.25 + 0.2 * d
        rgb = torch.where(hit[:, None], albedo * shade[:, None], bg)
        images[i] = (rgb.clamp(0, 1) * 255).to(torch.uint8).reshape(H, W, 3)
        masks[i] = (hit.to(torch.uint8) * 255).reshape(H, W)
    return (images.cpu().numpy(), masks.cpu().numpy(),
            camera_arrays(K, rt))
