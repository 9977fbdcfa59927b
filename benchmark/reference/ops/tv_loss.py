"""Point-sampled total-variation maps of the grid features (counterpart of
``ndjir_tpu/ops/tv_loss.py``).

At each query point the enclosing cell's corner feature f0 is compared with
its +1 neighbours along each axis of the layout; per channel the result is
the L2 norm of those forward differences.  The cosine and Lanczos variants
share their parent layout's cell TV (the reference registers them under
the same parameter scope).  Corner values are promoted to f32 before the
differences, the backward of the square root is stabilized as rsqrt(s +
1e-12), and ``sym_backward=False`` stops the gradient into f0 (reference
total_variation_loss_cuda.cu:45-85, :155-175).  The dense voxel's TV on
the training path comes from the query's own corner gather
(:func:`ndjir_torch.ops.grid.query_voxel_and_tv`); every other layout's
comes from here, one gather per layout, whose backward is one scatter (B1).
"""

from __future__ import annotations

import torch

from benchmark.reference.ops.lattice import (
    _PLANE_AXES,
    _corners,
    _hash_index,
    _hash_levels,
    _levels_to_channels,
    _to_grid,
    _vec,
)
from benchmark.reference.ops.scatter import gather_rows


class _TVSqrt(torch.autograd.Function):
    """sqrt(s) whose backward is g * 0.5 * rsqrt(s + 1e-12), the reference's
    stabilization (total_variation_loss_cuda.cu:155-175): a plain sqrt has an
    infinite gradient at s = 0, where two corners hold equal features."""

    @staticmethod
    def forward(ctx, s: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(s)
        return torch.sqrt(s)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (s,) = ctx.saved_tensors
        return g * 0.5 * torch.rsqrt(s + 1e-12)


def tv_sqrt(s: torch.Tensor) -> torch.Tensor:
    return _TVSqrt.apply(s)


def _gather4(flat: torch.Tensor, idx_list):
    """The corners of every id list from ONE gather, each (..., D) in f32
    (bf16 differences of near-equal values would cancel)."""
    idx = torch.stack(idx_list, dim=0)
    f = gather_rows(flat, idx.reshape(len(idx_list), -1))
    f = f.reshape(*idx.shape, flat.shape[-1]).float()
    return list(f.unbind(0))


def _base(f0: torch.Tensor, sym_backward: bool) -> torch.Tensor:
    return f0 if sym_backward else f0.detach()


def _cell(x: torch.Tensor, g1: torch.Tensor, vmin, vmax):
    """The clamped floor and ceil corner ids (int64, (..., 3) or
    (..., L, 3)) of each point's cell."""
    xyz = _to_grid(x, g1, _vec(vmin, x), _vec(vmax, x))
    xyz0, xyz1 = _corners(xyz, g1)
    return xyz0.detach().long(), xyz1.detach().long()


def tv_loss_voxel(x: torch.Tensor, feature: torch.Tensor, vmin, vmax,
                  sym_backward: bool = True) -> torch.Tensor:
    """(..., 3), (G, G, G, D) -> (..., D) (reference tv_loss.py:62)."""
    Gx, Gy, Gz, D = feature.shape
    i0, i1 = _cell(x, _vec([Gx - 1, Gy - 1, Gz - 1], x), vmin, vmax)
    sy, sx = Gz, Gy * Gz
    (x0, y0, z0), (x1, y1, z1) = i0.unbind(-1), i1.unbind(-1)
    f000, f100, f010, f001 = _gather4(feature.reshape(-1, D), [
        x0 * sx + y0 * sy + z0, x1 * sx + y0 * sy + z0,
        x0 * sx + y1 * sy + z0, x0 * sx + y0 * sy + z1])
    f000 = _base(f000, sym_backward)
    return tv_sqrt((f100 - f000) ** 2 + (f010 - f000) ** 2
                   + (f001 - f000) ** 2)


def tv_loss_triplane(x: torch.Tensor, feature: torch.Tensor, vmin, vmax,
                     sym_backward: bool = True) -> torch.Tensor:
    """(..., 3), (3, G, G, D) -> (..., 3D), channel 3d + plane (planes xy,
    yz, zx; reference tv_loss.py:88)."""
    _, G, _, D = feature.shape
    i0, i1 = _cell(x, _vec([G - 1] * 3, x), vmin, vmax)
    idx_list = []
    for p, (au, av) in enumerate(_PLANE_AXES):
        off = p * G * G
        u0, v0, u1, v1 = i0[..., au], i0[..., av], i1[..., au], i1[..., av]
        idx_list += [off + u0 * G + v0, off + u1 * G + v0, off + u0 * G + v1]
    fs = _gather4(feature.reshape(-1, D), idx_list)
    outs = []
    for p in range(3):
        f00 = _base(fs[3 * p], sym_backward)
        f10, f01 = fs[3 * p + 1], fs[3 * p + 2]
        outs.append(tv_sqrt((f10 - f00) ** 2 + (f01 - f00) ** 2))
    return torch.stack(outs, dim=-1).reshape(*x.shape[:-1], D * 3)


def tv_loss_triline(x: torch.Tensor, feature: torch.Tensor, vmin, vmax,
                    sym_backward: bool = True) -> torch.Tensor:
    """(..., 3), (3, G, D) -> (..., 3D), channel 3d + line (reference
    tv_loss.py:117)."""
    _, G, D = feature.shape
    i0, i1 = _cell(x, _vec([G - 1] * 3, x), vmin, vmax)
    idx_list = []
    for ax in range(3):
        idx_list += [ax * G + i0[..., ax], ax * G + i1[..., ax]]
    fs = _gather4(feature.reshape(-1, D), idx_list)
    outs = [tv_sqrt((fs[2 * ax + 1] - _base(fs[2 * ax], sym_backward)) ** 2)
            for ax in range(3)]
    return torch.stack(outs, dim=-1).reshape(*x.shape[:-1], D * 3)


def tv_loss_voxel_hash(x: torch.Tensor, feature: torch.Tensor, G0: int,
                       growth_factor: float, T0: int, L: int, D: int,
                       vmin, vmax, sym_backward: bool = True
                       ) -> torch.Tensor:
    """(..., 3), (n_params,) -> (..., D*L), channel d*L + l; the four
    corners of every level from one gather (reference tv_loss.py:142)."""
    xyz, g1b, Ts, row0s = _hash_levels(x, G0, growth_factor, T0, L, D,
                                       vmin, vmax)
    xyz0, xyz1 = _corners(xyz, g1b)
    (x0, y0, z0) = xyz0.detach().long().unbind(-1)
    (x1, y1, z1) = xyz1.detach().long().unbind(-1)
    fs = _gather4(feature.reshape(-1, D), [
        row0s + _hash_index(x0, y0, z0, Ts),
        row0s + _hash_index(x1, y0, z0, Ts),
        row0s + _hash_index(x0, y1, z0, Ts),
        row0s + _hash_index(x0, y0, z1, Ts)])  # each (..., L, D)
    f000 = _base(fs[0], sym_backward)
    s = (fs[1] - f000) ** 2 + (fs[2] - f000) ** 2 + (fs[3] - f000) ** 2
    return _levels_to_channels(tv_sqrt(s), x)


def grid_tv_loss(encoding, params, x: torch.Tensor,
                 sym_backward: bool = True) -> torch.Tensor:
    """The TV map of a :class:`~ndjir_torch.ops.grid.GridEncoding`'s
    parameter family, channels concatenated (..., C); triplaneline takes
    both the triplane's and the triline's (reference tv_loss.py:188,
    loss.py:79-105)."""
    t, f = encoding.type, encoding.family
    box = (encoding.vmin, encoding.vmax)
    if t == "none":
        return torch.zeros((*x.shape[:-1], 1), dtype=x.dtype,
                           device=x.device)
    if f == "voxel_hash":
        return tv_loss_voxel_hash(x, params["F"], *encoding.hash_args, *box,
                                  sym_backward)
    if f == "triplaneline":
        return torch.cat([
            tv_loss_triplane(x, params["plane_F"], *box, sym_backward),
            tv_loss_triline(x, params["line_F"], *box, sym_backward)], dim=-1)
    fn = {"triplane": tv_loss_triplane, "triline": tv_loss_triline,
          "voxel": tv_loss_voxel}[f]
    return fn(x, params["F"], *box, sym_backward)
