"""Coordinate, cell and hash helpers shared by the grid queries
(:mod:`ndjir_torch.ops.grid`) and their TV maps
(:mod:`ndjir_torch.ops.tv_loss`): world to grid coordinates, the clamped
cell corners, the triplane's plane axes, and the voxel hash's sizing
(reference ``ndjir_tpu/ops/grid.py:992-1033``) and spatial hash.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ndjir_torch.ops.consts import device_const

Vec3 = Sequence[float]
DEFAULT_MIN = (-1.0, -1.0, -1.0)
DEFAULT_MAX = (1.0, 1.0, 1.0)


def _to_grid(x: torch.Tensor, grid_sizes1: torch.Tensor, vmin: torch.Tensor,
             vmax: torch.Tensor) -> torch.Tensor:
    """World coords (..., 3) -> continuous grid coords in [0, G-1]."""
    scales = grid_sizes1 / (vmax - vmin)
    return (x - vmin) * scales


def _corners(xyz: torch.Tensor, grid_sizes1: torch.Tensor):
    """Clamped floor/ceil corner coordinates (float, for weight math)."""
    xyz0 = torch.minimum(torch.clamp_min(torch.floor(xyz), 0.0), grid_sizes1)
    xyz1 = torch.minimum(xyz0 + 1.0, grid_sizes1)
    return xyz0, xyz1


def _vec(v, x: torch.Tensor) -> torch.Tensor:
    return device_const(tuple(v), x.dtype, x.device)


# (xy, yz, zx): common_triplane.cuh:44-66
_PLANE_AXES = ((0, 1), (1, 2), (2, 0))


# tcnn primes (voxel_hash_feature_cuda.cu:39)
_HASH_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def hash_grid_size(G0: int, growth_factor: float, level: int) -> int:
    return int(G0 * growth_factor ** level)


def hash_table_size(G: int, T0: int) -> int:
    return int(min(float(G) ** 3, float(T0)))


def _force_align(size: int, mod: int = 8) -> int:
    # the reference's quirk, kept so that a reference checkpoint maps 1:1:
    # it ADDS the remainder instead of padding to a multiple
    # (common_voxel_hash.cuh:24-28)
    return size + size % mod


def hash_num_params(G0: int, growth_factor: float, T0: int, L: int,
                    D: int) -> int:
    return sum(_force_align(hash_table_size(
        hash_grid_size(G0, growth_factor, l), T0) * D) for l in range(L))


def hash_level_offsets(G0: int, growth_factor: float, T0: int, L: int,
                       D: int) -> Tuple[Tuple[int, int, int], ...]:
    """Per level, (offset into the flat buffer, G_l, T_l)."""
    out, off = [], 0
    for l in range(L):
        G = hash_grid_size(G0, growth_factor, l)
        T = hash_table_size(G, T0)
        out.append((off, G, T))
        off += _force_align(T * D)
    return tuple(out)


def _hash_index(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor,
                T) -> torch.Tensor:
    """The tcnn spatial hash of corner coords (int64, >= 0) into ``T`` rows
    (an int, or a tensor that broadcasts, such as one size per level).
    The reference multiplies in uint32 and wraps mod 2^32; the products
    here are exact in int64 (coords < 2^31, primes < 2^32) and masked to
    their low 32 bits, so the ids are the same."""
    p0, p1, p2 = _HASH_PRIMES
    h = (ix * p0) & _U32
    h = h ^ ((iy * p1) & _U32)
    h = h ^ ((iz * p2) & _U32)
    return h % T


def _hash_levels(x: torch.Tensor, G0, growth_factor, T0, L, D, vmin, vmax):
    """Per-level metadata and the continuous coords of every level:
    (xyz (..., L, 3), G-1 (L, 3), table sizes (L,), first rows (L,)), the
    sizes and rows as int64 of the (n_params / D, D) view."""
    levels = hash_level_offsets(G0, growth_factor, T0, L, D)
    for off, _, _ in levels:
        assert off % D == 0, "level offset not divisible by feature dim"
    dev = x.device
    g1s = device_const([[G - 1] for _, G, _ in levels], x.dtype, dev)
    Ts = device_const([T for _, _, T in levels], torch.int64, dev)
    row0s = device_const([off // D for off, _, _ in levels], torch.int64,
                         dev)
    scales = g1s / (_vec(vmax, x) - _vec(vmin, x))          # (L, 3)
    xyz = (x[..., None, :] - _vec(vmin, x)) * scales        # (..., L, 3)
    return xyz, g1s.expand(L, 3), Ts, row0s


def _levels_to_channels(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., L, D) -> (..., D*L), channel d*L + l (reference
    grid.py:1131-1132)."""
    L, D = acc.shape[-2:]
    return acc.transpose(-1, -2).reshape(*x.shape[:-1], D * L)
