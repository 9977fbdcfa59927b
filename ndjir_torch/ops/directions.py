"""Hemisphere light-direction sampling, uniform and GGX importance
(counterpart of ``ndjir_tpu/ops/directions.py``; reference:
csrc/sampling/inverse_transform_cuda.cu:30-136).

Per-pixel CDF samples for theta (n_thetas,) and phi (n_phis,) form the outer
product grid M = n_thetas * n_phis, rotated into the tangent frame of the
surface normal.  Callers treat the result as sample generation (detached).
"""

from __future__ import annotations

import math

import torch

from ndjir_torch.ops.consts import device_const


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                               1e-12)


def _tangent_frame(normal: torch.Tensor, eps: float):
    """(x_axis, y_axis, z_axis) of the tangent->world rotation:
    z = normalize(n + eps); x = normalize([-n.y, n.x, 0]); y = z cross x.
    Where n is (anti)parallel to z the x axis falls back to the world x axis
    (the reference divides by zero there)."""
    n = normal + eps
    z_axis = _normalize(n)
    xa = torch.stack([-n[..., 1], n[..., 0], torch.zeros_like(n[..., 0])],
                     dim=-1)
    degenerate = torch.linalg.norm(xa, dim=-1, keepdim=True) < 1e-9
    fallback = device_const((1.0, 0.0, 0.0), n.dtype,
                            n.device).expand_as(xa)
    x_axis = _normalize(torch.where(degenerate, fallback, xa))
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=-1)
    return x_axis, y_axis, z_axis


def _orient(local_dirs: torch.Tensor, normal: torch.Tensor,
            eps: float) -> torch.Tensor:
    """Rotate local (tangent-space) directions (..., M, 3) into world space."""
    x_axis, y_axis, z_axis = _tangent_frame(normal, eps)
    return (local_dirs[..., 0:1] * x_axis[..., None, :]
            + local_dirs[..., 1:2] * y_axis[..., None, :]
            + local_dirs[..., 2:3] * z_axis[..., None, :])


def _outer_grid(cdf_the: torch.Tensor, cdf_phi: torch.Tensor):
    """(..., n_the) x (..., n_phi) -> the flat (..., M) light grid, theta
    major: light m = (m // n_phi, m % n_phi)."""
    n_the = cdf_the.shape[-1]
    n_phi = cdf_phi.shape[-1]
    the = torch.repeat_interleave(cdf_the, n_phi, dim=-1)
    phi = cdf_phi.repeat(*((1,) * (cdf_phi.ndim - 1)), n_the)
    return the, phi


def _local(cos_the: torch.Tensor, phi_u: torch.Tensor) -> torch.Tensor:
    phi = 2.0 * math.pi * phi_u
    sin_the = torch.sqrt(torch.clamp_min(1.0 - cos_the * cos_the, 0.0))
    return torch.stack([sin_the * torch.cos(phi), sin_the * torch.sin(phi),
                        cos_the], dim=-1)


def sample_uniform_directions(normal: torch.Tensor, cdf_the: torch.Tensor,
                              cdf_phi: torch.Tensor,
                              eps: float = 0.0) -> torch.Tensor:
    """Uniform-in-cos-theta hemisphere directions around ``normal``:
    normal (B, R, 3), cdf_the (B, R, n_thetas), cdf_phi (B, R, n_phis)
    -> (B, R, M, 3) with cos(theta) = cdf_the."""
    the, phi_u = _outer_grid(cdf_the, cdf_phi)
    return _orient(_local(the, phi_u), normal, eps)


def sample_importance_directions(normal: torch.Tensor, cdf_the: torch.Tensor,
                                 cdf_phi: torch.Tensor, alpha: torch.Tensor,
                                 eps: float = 0.0) -> torch.Tensor:
    """GGX-NDF importance-sampled directions:
    cos(theta) = sqrt((1 - u) / ((a^2 - 1) u + 1)), a = ``alpha`` (B, R, 1)."""
    the, phi_u = _outer_grid(cdf_the, cdf_phi)
    a2 = alpha * alpha
    cos_the = torch.sqrt(torch.clamp((1.0 - the) / ((a2 - 1.0) * the + 1.0),
                                     0.0, 1.0))
    return _orient(_local(cos_the, phi_u), normal, eps)
