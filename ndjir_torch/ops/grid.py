"""Dense voxel grid feature encoding, twice-differentiable in the query point.

Counterpart of ``ndjir_tpu/ops/grid.py``, dense-voxel branches over a
(G, G, G, D) table (reference voxel_feature.py:160):

- 8-corner: each point reads the 8 corners of its cell through
  :class:`~ndjir_torch.ops.scatter.GatherRows`, whose backward is the
  scatter kernel (B1).  Every f32 table takes it.
- octa: a bf16 table whose 8-corner-packed rows would take at most
  1.2 GB (:func:`use_octa_layout`, the JAX package's rule) reads one 8D-wide
  row per point through :class:`GatherRowsOcta`, whose backward is B1 in
  transposed form followed by the fold kernel (B2).  The port gathers the
  8 clamped corners straight from the base table instead of building the
  duplicated table; the rows are the same bits.

The reference's z-dup and packed layouts exist for XLA on a TPU and give
the 8-corner numbers; the port does not have them.

Interpolation weights:
  linear : w0 = x1 - x                        (voxel_feature_cuda.cu)
  cosine : w0 = 0.5 cos(pi (x - x0)) + 0.5    (cosine_voxel_feature_cuda.cu:65)
The gradient with respect to the query point flows through the weights only
(corner ids are integer), so ∇ₓ and its grad-of-grad are ordinary autograd.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from torch.autograd.function import once_differentiable

from ndjir_torch.ops.fold import fold_octa_cotangent
from ndjir_torch.ops.scatter import gather_rows, scatter_add_rows_t
from ndjir_torch.ops.tv_loss import tv_sqrt

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


def _weights(xyz: torch.Tensor, xyz0: torch.Tensor, xyz1: torch.Tensor,
             kind: str):
    """Per-axis corner-0 weight; corner-1 weight is its complement."""
    if kind == "linear":
        w0 = xyz1 - xyz
    elif kind == "cosine":
        w0 = 0.5 * torch.cos(math.pi * (xyz - xyz0)) + 0.5
    else:
        raise ValueError(f"Unknown interpolation: {kind}")
    return w0, 1.0 - w0


def voxel_corners(x: torch.Tensor, gshape, vmin: Vec3 = DEFAULT_MIN,
                  vmax: Vec3 = DEFAULT_MAX, weight: str = "linear"
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Flat row ids (8, ...) int64 and weights [8 x (...)] of each point's
    cell corners, corner c = (cx, cy, cz) at c = 4 cx + 2 cy + cz."""
    Gx, Gy, Gz, _ = gshape
    dtype, dev = x.dtype, x.device
    g1 = torch.tensor([Gx - 1, Gy - 1, Gz - 1], dtype=dtype, device=dev)
    xyz = _to_grid(x, g1, torch.tensor(vmin, dtype=dtype, device=dev),
                   torch.tensor(vmax, dtype=dtype, device=dev))
    xyz0, xyz1 = _corners(xyz, g1)
    w0, w1 = _weights(xyz, xyz0, xyz1, weight)
    i0 = xyz0.detach().long()
    i1 = xyz1.detach().long()
    sy, sx = Gz, Gy * Gz

    idx_list, w_list = [], []
    for cx in range(2):
        ix = (i0 if cx == 0 else i1)[..., 0]
        wx = (w0 if cx == 0 else w1)[..., 0]
        for cy in range(2):
            iy = (i0 if cy == 0 else i1)[..., 1]
            wy = (w0 if cy == 0 else w1)[..., 1]
            for cz in range(2):
                iz = (i0 if cz == 0 else i1)[..., 2]
                wz = (w0 if cz == 0 else w1)[..., 2]
                idx_list.append(ix * sx + iy * sy + iz)
                w_list.append(wx * wy * wz)
    return torch.stack(idx_list, dim=0), w_list


def _gather_corners(x, feature, vmin, vmax, weight):
    """(corner features (8, ..., D), weights (8, ...)) via ONE gather, so
    the backward issues one scatter for all corners."""
    D = feature.shape[-1]
    idx, w_list = voxel_corners(x, feature.shape, vmin, vmax, weight)
    f = gather_rows(feature.reshape(-1, D), idx.reshape(8, -1))
    return f.reshape(*idx.shape, D), torch.stack(w_list, dim=0)


# ---------------------------------------------------------------------------
# octa layout: all 8 cell corners in one 8D-wide row
# ---------------------------------------------------------------------------

# the JAX package's budget for the duplicated octa table (grid.py:143)
_OCTA_MAX_BYTES = 1_200_000_000


def use_octa_layout(gshape, dtype) -> bool:
    """Whether a table of this shape and dtype takes the octa layout: bf16,
    and the (G^3, 8D) bf16 rows would fit the budget (G=256, D=4: 1.07 GB
    does; G=512 does not)."""
    Gx, Gy, Gz, D = gshape
    return dtype == torch.bfloat16 and Gx * Gy * Gz * 8 * D * 2 \
        <= _OCTA_MAX_BYTES


def voxel_octa_ids(x: torch.Tensor, gshape, vmin: Vec3 = DEFAULT_MIN,
                   vmax: Vec3 = DEFAULT_MAX) -> torch.Tensor:
    """(*x.shape[:-1],) int64 octa row ids: the flat id of each point's
    clamped floor corner (reference grid.py:568)."""
    Gx, Gy, Gz, _ = gshape
    dtype, dev = x.dtype, x.device
    g1 = torch.tensor([Gx - 1, Gy - 1, Gz - 1], dtype=dtype, device=dev)
    xyz = _to_grid(x, g1, torch.tensor(vmin, dtype=dtype, device=dev),
                   torch.tensor(vmax, dtype=dtype, device=dev))
    i0 = _corners(xyz, g1)[0].detach().long()
    return i0[..., 0] * (Gy * Gz) + i0[..., 1] * Gz + i0[..., 2]


def octa_corner_ids(ids: torch.Tensor, gshape) -> torch.Tensor:
    """(N,) octa row ids -> (N, 8) flat ids of the row's corner cells
    (x+dx, y+dy, z+dz), column dx*4 + dy*2 + dz, each +1 clamped to the
    last slice of its axis (reference ``_voxel_octa_flat``, grid.py:153)."""
    Gx, Gy, Gz, _ = gshape
    iz = ids % Gz
    iy = (ids // Gz) % Gy
    ix = ids // (Gy * Gz)
    xs = (ix, torch.clamp_max(ix + 1, Gx - 1))
    ys = (iy, torch.clamp_max(iy + 1, Gy - 1))
    zs = (iz, torch.clamp_max(iz + 1, Gz - 1))
    return torch.stack([(xs[dx] * Gy + ys[dy]) * Gz + zs[dz]
                        for dx in range(2) for dy in range(2)
                        for dz in range(2)], dim=-1)


class GatherRowsOcta(torch.autograd.Function):
    """base (Gx, Gy, Gz, D), ids (N,) octa row ids -> (N, 8D) rows, the
    reference's ``gather_rows_octa`` (grid.py:514).  Forward: the 8 clamped
    corners of each row gathered from the base table, a pure copy.
    Backward: B1 into the transposed (8D, G^3) f32 cotangent, then the fold
    (B2), rounded once to the cotangent's dtype (grid.py:555-562)."""

    @staticmethod
    def forward(ctx, base: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        D = base.shape[-1]
        ctx.save_for_backward(ids)
        ctx.gshape = tuple(base.shape)
        corners = octa_corner_ids(ids, base.shape)
        return base.reshape(-1, D).index_select(0, corners.reshape(-1)) \
            .reshape(ids.shape[0], 8 * D)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        (ids,) = ctx.saved_tensors
        Gx, Gy, Gz, _ = ctx.gshape
        cot_t = scatter_add_rows_t(ids, g, Gx * Gy * Gz)
        return fold_octa_cotangent(cot_t, ctx.gshape, g.dtype), None


def voxel_gather_multi(x_list, feature: torch.Tensor,
                       vmin: Vec3 = DEFAULT_MIN, vmax: Vec3 = DEFAULT_MAX):
    """Octa rows (*x.shape[:-1], 8D) for SEVERAL point sets from ONE
    :class:`GatherRowsOcta` call, so the backward issues one B1 and one B2
    launch for all of them (reference grid.py:637-660).  The table must
    take the octa layout (:func:`use_octa_layout`)."""
    if not use_octa_layout(feature.shape, feature.dtype):
        raise ValueError(f"a {tuple(feature.shape)} {feature.dtype} table "
                         "does not take the octa layout")
    ids = [voxel_octa_ids(x, feature.shape, vmin, vmax) for x in x_list]
    f = GatherRowsOcta.apply(feature, torch.cat([i.reshape(-1)
                                                 for i in ids]))
    out, off = [], 0
    for i in ids:
        out.append(f[off:off + i.numel()].reshape(*i.shape, f.shape[-1]))
        off += i.numel()
    return out


def voxel_interp_octa(x: torch.Tensor, f: torch.Tensor, gshape,
                      vmin: Vec3 = DEFAULT_MIN, vmax: Vec3 = DEFAULT_MAX,
                      weight: str = "linear") -> torch.Tensor:
    """Trilinear/cosine combine of octa rows f (..., 8D): the nested pair
    reduction over the x, then y, then z block halves (reference
    grid.py:581).  Differentiable in ``x`` through the weights only."""
    Gx, Gy, Gz, D = gshape
    dtype, dev = x.dtype, x.device
    g1 = torch.tensor([Gx - 1, Gy - 1, Gz - 1], dtype=dtype, device=dev)
    xyz = _to_grid(x, g1, torch.tensor(vmin, dtype=dtype, device=dev),
                   torch.tensor(vmax, dtype=dtype, device=dev))
    xyz0, xyz1 = _corners(xyz, g1)
    w0, w1 = _weights(xyz, xyz0, xyz1, weight)
    fx = w0[..., 0:1] * f[..., :4 * D] + w1[..., 0:1] * f[..., 4 * D:]
    fy = w0[..., 1:2] * fx[..., :2 * D] + w1[..., 1:2] * fx[..., 2 * D:]
    return w0[..., 2:3] * fy[..., :D] + w1[..., 2:3] * fy[..., D:]


def voxel_tv_octa(f: torch.Tensor, dtype: torch.dtype,
                  sym_backward: bool = True) -> torch.Tensor:
    """Cell TV map from octa rows f (..., 8D), in ``dtype`` (blocks
    000=0, 001=1, 010=2, 100=4; reference grid.py:597)."""
    D = f.shape[-1] // 8
    f000, f001, f010, f100 = (f[..., b * D:(b + 1) * D].to(dtype)
                              for b in (0, 1, 2, 4))
    base = f000 if sym_backward else f000.detach()
    s = (f100 - base) ** 2 + (f010 - base) ** 2 + (f001 - base) ** 2
    return tv_sqrt(s)


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------

def query_voxel(x: torch.Tensor, feature: torch.Tensor,
                vmin: Vec3 = DEFAULT_MIN, vmax: Vec3 = DEFAULT_MAX,
                weight: str = "linear") -> torch.Tensor:
    """Trilinear (or cosine-weighted) dense-grid query: (..., 3) -> (..., D)
    (reference grid.py:721: octa branch :735-738, 8-corner :740-761)."""
    if use_octa_layout(feature.shape, feature.dtype):
        (f,) = voxel_gather_multi([x], feature, vmin, vmax)
        return voxel_interp_octa(x, f, feature.shape, vmin, vmax, weight)
    f, w = _gather_corners(x, feature, vmin, vmax, weight)
    return torch.sum(w[..., None] * f, dim=0)


def query_voxel_and_tv(x: torch.Tensor, feature: torch.Tensor,
                       vmin: Vec3 = DEFAULT_MIN, vmax: Vec3 = DEFAULT_MAX,
                       weight: str = "linear", sym_backward: bool = True):
    """Trilinear query + cell TV map sharing ONE corner gather
    (reference grid.py:764, 8-corner branch :791-824).

    TV at a point: per channel, the L2 norm of the forward differences of
    its cell's corner 000 to corners 100, 010 and 001, in the point's dtype.
    ``sym_backward=False`` stops the gradient into the base corner.  Returns
    (interp (..., D), tv (..., D)).  Octa tables take the octa branch
    (:781-784).
    """
    if use_octa_layout(feature.shape, feature.dtype):
        (f,) = voxel_gather_multi([x], feature, vmin, vmax)
        interp = voxel_interp_octa(x, f, feature.shape, vmin, vmax, weight)
        return interp, voxel_tv_octa(f, x.dtype, sym_backward)
    f, w = _gather_corners(x, feature, vmin, vmax, weight)
    interp = torch.sum(w[..., None] * f, dim=0)
    # corner order (cx, cy, cz): 000=0, 001=1, 010=2, 100=4
    f000, f001, f010, f100 = (f[c].to(x.dtype) for c in (0, 1, 2, 4))
    base = f000 if sym_backward else f000.detach()
    s = (f100 - base) ** 2 + (f010 - base) ** 2 + (f001 - base) ** 2
    return interp, tv_sqrt(s)


def init_voxel(generator: torch.Generator, G: int, D: int, eps: float = 1e-3,
               dtype=torch.float32, device="cuda") -> torch.Tensor:
    """N(0, eps) init (reference: voxel_feature.py:155-163)."""
    return eps * torch.randn((G, G, G, D), generator=generator, dtype=dtype,
                             device=device)


class GridEncoding:
    """Config-driven grid encoding: init(generator) -> params,
    apply(params, x) (reference grid.py:1191).  Ported types: ``none``,
    ``voxel`` and ``cosine_voxel``."""

    PORTED = ("none", "voxel", "cosine_voxel")

    def __init__(self, conf_voxel, radius: float = 1.0):
        c = conf_voxel
        self.type = c.type
        if self.type not in self.PORTED:
            raise NotImplementedError(
                f"grid type {self.type!r} is not ported yet (ROADMAP A12: "
                "other encodings); ported: " + ", ".join(self.PORTED))
        self.G = int(c.grid_size)
        self.D = int(c.feature_size)
        self.use_ste = bool(c.use_ste)
        self.vmin = (-radius, -radius, -radius)
        self.vmax = (radius, radius, radius)
        self.kind = "cosine" if self.type.startswith("cosine_") else "linear"

    @property
    def out_dim(self) -> int:
        return 0 if self.type == "none" else self.D

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda"):
        if self.type == "none":
            return {}
        return {"F": init_voxel(generator, self.G, self.D, dtype=dtype,
                                device=device)}

    def _x(self, x: torch.Tensor) -> torch.Tensor:
        # straight-through: the grid adds no d(feature)/dx to the normal /
        # eikonal double backward (reference voxel_feature.py:383-397);
        # feature gradients still flow
        return x.detach() if self.use_ste else x

    def apply_with_tv(self, params, x: torch.Tensor, sym_backward: bool = True):
        """(features, tv_map) from one shared corner gather."""
        return query_voxel_and_tv(self._x(x), params["F"], self.vmin,
                                  self.vmax, self.kind, sym_backward)

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        if self.type == "none":
            raise ValueError("apply() on type='none'")
        return query_voxel(self._x(x), params["F"], self.vmin, self.vmax,
                           self.kind)
