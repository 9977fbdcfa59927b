"""Ray / bounding-volume intersection (counterpart of
``ndjir_tpu/ops/intersect.py``; reference CUDA semantics:
csrc/intersection/ray_{sphere,aabb}_intersection_cuda.cu).

Shapes: camloc (B, 3), raydir (B, R, 3) -> t_near/t_far/n_hits (B, R, 1).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from benchmark.reference.ops.consts import device_const


def ray_sphere_intersection(camloc: torch.Tensor, raydir: torch.Tensor,
                            radius: float = 1.0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Quadratic ray-sphere solve; t_near clamped to >= 0.

    n_hits is 0 (miss), 1 (tangent, or camera inside: t_near < 0), or 2.
    """
    c = camloc[:, None, :]  # (B, 1, 3)
    cv = torch.sum(c * raydir, dim=-1, keepdim=True)
    vv = torch.sum(raydir * raydir, dim=-1, keepdim=True)
    cc = torch.sum(c * c, dim=-1, keepdim=True)
    X = -cv
    Y = cv * cv - vv * (cc - radius * radius)
    Z_inv = 1.0 / vv

    Y_sqrt = torch.sqrt(torch.clamp_min(Y, 0.0))
    t_near2 = (X - Y_sqrt) * Z_inv
    t_far2 = (X + Y_sqrt) * Z_inv
    pos = (t_near2 >= 0.0).to(camloc.dtype)

    zero = torch.zeros_like(X)
    two = Y > 0.0
    tangent = Y == 0.0
    t_near = torch.where(two, pos * t_near2,
                         torch.where(tangent, X * Z_inv, zero))
    t_far = torch.where(two, t_far2, torch.where(tangent, X * Z_inv, zero))
    n_hits = torch.where(two, 2.0 - (1.0 - pos),
                         torch.where(tangent, torch.ones_like(X), zero))
    return t_near, t_far, n_hits.to(camloc.dtype)


def ray_aabb_intersection(camloc: torch.Tensor, raydir: torch.Tensor,
                          box_min: Sequence[float], box_max: Sequence[float]
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Six-face slab candidate test with numerical-error snapping.

    Each candidate point has its plane coordinate snapped exactly to the
    face before the inside-test (reference
    ray_aabb_intersection_cuda.cu:60-67).  t_near/t_far come from the
    first/last hit in face order (max.x, max.y, max.z, min.x, min.y, min.z),
    sorted; a single hit means the camera is inside the box (t_near = 0).
    """
    dtype, dev = camloc.dtype, camloc.device
    bmin = device_const(tuple(box_min), dtype, dev)
    bmax = device_const(tuple(box_max), dtype, dev)
    c = camloc[:, None, :]  # (B, 1, 3)
    inv_d = 1.0 / raydir     # inf on axis-parallel rays, handled below

    t_max = (bmax - c) * inv_d  # (B, R, 3)
    t_min = (bmin - c) * inv_d
    t_list = torch.cat([t_max, t_min], dim=-1)  # (B, R, 6)

    x = c[..., None, :] + t_list[..., :, None] * raydir[..., None, :]
    face_value = torch.stack([bmax[0], bmax[1], bmax[2],
                              bmin[0], bmin[1], bmin[2]])
    # each face's axis, one-hot
    axis_onehot = device_const(((1, 0, 0), (0, 1, 0), (0, 0, 1)) * 2, dtype,
                               dev)
    x = x * (1.0 - axis_onehot) + face_value[:, None] * axis_onehot

    inside = ((x >= bmin) & (x <= bmax)).all(dim=-1)  # (B, R, 6)
    cond = inside & (t_list >= 0.0) & torch.isfinite(t_list)

    n_hits = torch.sum(cond, dim=-1, keepdim=True).to(dtype)

    # argmax returns the first maximal index, as jnp.argmax does
    first = torch.argmax(cond.to(torch.int8), dim=-1)
    last = 5 - torch.argmax(cond.flip(-1).to(torch.int8), dim=-1)
    ta = torch.gather(t_list, -1, first[..., None])
    tb = torch.gather(t_list, -1, last[..., None])

    zero = torch.zeros_like(ta)
    t_near2 = torch.minimum(ta, tb)
    t_far2 = torch.maximum(ta, tb)
    t_near = torch.where(n_hits >= 2, t_near2, zero)
    t_far = torch.where(n_hits >= 2, t_far2,
                        torch.where(n_hits == 1, ta, zero))
    return t_near, t_far, n_hits
