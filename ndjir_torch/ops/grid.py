"""Grid feature encodings, twice-differentiable in the query point.

Counterpart of ``ndjir_tpu/ops/grid.py``.  Layouts (reference parity):

  dense voxel : (G, G, G, D)                  voxel_feature.py:160
  triplane    : (3, G, G, D), planes xy, yz, zx
  triline     : (3, G, D), lines x, y, z
  voxel hash  : flat (n_params,), per-level offsets aligned by the
                reference's ``_force_align`` quirk; output channel d*L + l

Every query gathers its table rows through
:class:`~ndjir_torch.ops.scatter.GatherRows`, ONE call per query (all
corners, taps and hash levels batched), so its backward is one launch of
the scatter kernel (B1).  The dense voxel has two more branches:

- 8-corner: each point reads the 8 corners of its cell.  Every f32 table
  takes it.
- octa: a bf16 table whose 8-corner-packed rows would take at most
  1.2 GB (:func:`use_octa_layout`, the JAX package's rule) reads one 8D-wide
  row per point through :class:`GatherRowsOcta`, whose backward is B1 in
  transposed form followed by the fold kernel (B2).  Training gathers the
  8 clamped corners straight from the base table instead of building the
  duplicated table; the rows are the same bits.  Inference, whose table is
  frozen, builds the duplicated table once per call (B3,
  :func:`~ndjir_torch.ops.octa_build.build_octa_table`) and passes it in
  as ``octa_table``: each point then reads one contiguous row of it
  (:func:`gather_octa_table`), as the JAX package's forward does.

The reference's z-dup and packed layouts exist for XLA on a TPU and give
the 8-corner numbers; the port does not have them.

A dense Lanczos query on the card that builds no autograd graph (the
proposal sampler's, ``render_image``'s and an extraction's) gathers nothing
through :class:`GatherRows`: it is one launch of the Lanczos gather kernel
(:mod:`ndjir_torch.ops.lanczos_gather`), which gives the composite's bits.

Interpolation weights:
  linear : w0 = x1 - x                        (voxel_feature_cuda.cu)
  cosine : w0 = 0.5 cos(pi (x - x0)) + 0.5    (cosine_voxel_feature_cuda.cu:65)
  lanczos: sinc(x) sinc(x / 2), 4 taps per axis, taps clamped to the table
           and their coefficients taken at the clamped position, with NO
           window cutoff or renormalisation (lanczos_voxel_feature_cuda.cu)
The gradient with respect to the query point flows through the weights only
(row ids are integer), so ∇ₓ and its grad-of-grad are ordinary autograd.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from torch.autograd.function import once_differentiable

from ndjir_torch.ops.consts import device_const
from ndjir_torch.ops.fold import fold_octa_cotangent
from ndjir_torch.ops.lanczos_gather import (
    lanczos_voxel_gather,
    sums_in_warps,
)
from ndjir_torch.ops.lattice import (
    _PLANE_AXES,
    DEFAULT_MAX,
    DEFAULT_MIN,
    Vec3,
    _corners,
    _hash_index,
    _hash_levels,
    _levels_to_channels,
    _to_grid,
    _vec,
    hash_num_params,
)
from ndjir_torch.ops.scatter import gather_rows, scatter_add_rows_t
from ndjir_torch.ops.tv_loss import grid_tv_loss, tv_sqrt
from ndjir_torch.utils.profiling import annotate


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
    g1 = device_const((Gx - 1, Gy - 1, Gz - 1), dtype, dev)
    xyz = _to_grid(x, g1, device_const(tuple(vmin), dtype, dev),
                   device_const(tuple(vmax), dtype, dev))
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
    g1 = device_const((Gx - 1, Gy - 1, Gz - 1), dtype, dev)
    xyz = _to_grid(x, g1, device_const(tuple(vmin), dtype, dev),
                   device_const(tuple(vmax), dtype, dev))
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
    (B2), rounded once to the cotangent's dtype (grid.py:555-562).  Each
    direction is a program span (``grid.octa_gather``,
    ``grid.octa_backward``) carrying its ``rows``."""

    @staticmethod
    def forward(ctx, base: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        D = base.shape[-1]
        ctx.save_for_backward(ids)
        ctx.gshape = tuple(base.shape)
        with annotate("grid.octa_gather", rows=ids.shape[0]):
            corners = octa_corner_ids(ids, base.shape)
            return base.reshape(-1, D).index_select(
                0, corners.reshape(-1)).reshape(ids.shape[0], 8 * D)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        (ids,) = ctx.saved_tensors
        Gx, Gy, Gz, _ = ctx.gshape
        with annotate("grid.octa_backward", rows=ids.shape[0]):
            cot_t = scatter_add_rows_t(ids, g, Gx * Gy * Gz)
            return fold_octa_cotangent(cot_t, ctx.gshape, g.dtype), None


def gather_octa_table(octa_table: torch.Tensor, ids: torch.Tensor,
                      base: torch.Tensor) -> torch.Tensor:
    """(N, 8D) rows of a prebuilt octa table (the build of ``base``) for
    octa row ids (N,): the JAX package's ``table[ids]`` (grid.py:548), a
    plain gather.  The rows are constants; a query still differentiates in
    the point through the interpolation weights.  Refuses a ``base`` that
    requires grad: the table gradient only flows through
    :class:`GatherRowsOcta`."""
    if base.requires_grad:
        raise RuntimeError("a prebuilt octa table carries no gradient to "
                           "its base table; a differentiated table must "
                           "take GatherRowsOcta")
    Gx, Gy, Gz, D = base.shape
    if tuple(octa_table.shape) != (Gx * Gy * Gz, 8 * D) \
            or octa_table.dtype != base.dtype:
        raise ValueError(f"octa table {tuple(octa_table.shape)} "
                         f"{octa_table.dtype} is not the build of a "
                         f"{tuple(base.shape)} {base.dtype} table")
    return octa_table.index_select(0, ids)


def voxel_gather_multi(x_list, feature: torch.Tensor,
                       vmin: Vec3 = DEFAULT_MIN, vmax: Vec3 = DEFAULT_MAX,
                       octa_table: torch.Tensor | None = None):
    """Octa rows (*x.shape[:-1], 8D) for SEVERAL point sets from ONE
    :class:`GatherRowsOcta` call, so the backward issues one B1 and one B2
    launch for all of them (reference grid.py:637-660); from the prebuilt
    ``octa_table`` of ``feature`` when one is given
    (:func:`gather_octa_table`).  The table must take the octa layout
    (:func:`use_octa_layout`)."""
    if not use_octa_layout(feature.shape, feature.dtype):
        raise ValueError(f"a {tuple(feature.shape)} {feature.dtype} table "
                         "does not take the octa layout")
    ids = [voxel_octa_ids(x, feature.shape, vmin, vmax) for x in x_list]
    flat = torch.cat([i.reshape(-1) for i in ids])
    f = GatherRowsOcta.apply(feature, flat) if octa_table is None \
        else gather_octa_table(octa_table, flat, feature)
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
    g1 = device_const((Gx - 1, Gy - 1, Gz - 1), dtype, dev)
    xyz = _to_grid(x, g1, device_const(tuple(vmin), dtype, dev),
                   device_const(tuple(vmax), dtype, dev))
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
                weight: str = "linear",
                octa_table: torch.Tensor | None = None) -> torch.Tensor:
    """Trilinear (or cosine-weighted) dense-grid query: (..., 3) -> (..., D)
    (reference grid.py:721: octa branch :735-738, 8-corner :740-761).  An
    octa table's rows come from ``octa_table`` when it is given."""
    if use_octa_layout(feature.shape, feature.dtype):
        (f,) = voxel_gather_multi([x], feature, vmin, vmax, octa_table)
        return voxel_interp_octa(x, f, feature.shape, vmin, vmax, weight)
    f, w = _gather_corners(x, feature, vmin, vmax, weight)
    return torch.sum(w[..., None] * f, dim=0)


def query_voxel_and_tv(x: torch.Tensor, feature: torch.Tensor,
                       vmin: Vec3 = DEFAULT_MIN, vmax: Vec3 = DEFAULT_MAX,
                       weight: str = "linear", sym_backward: bool = True,
                       octa_table: torch.Tensor | None = None):
    """Trilinear query + cell TV map sharing ONE corner gather
    (reference grid.py:764, 8-corner branch :791-824).

    TV at a point: per channel, the L2 norm of the forward differences of
    its cell's corner 000 to corners 100, 010 and 001, in the point's dtype.
    ``sym_backward=False`` stops the gradient into the base corner.  Returns
    (interp (..., D), tv (..., D)).  Octa tables take the octa branch
    (:781-784), reading ``octa_table`` when it is given.
    """
    if use_octa_layout(feature.shape, feature.dtype):
        (f,) = voxel_gather_multi([x], feature, vmin, vmax, octa_table)
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


# ---------------------------------------------------------------------------
# the other encodings: one batched gather per query
# ---------------------------------------------------------------------------

def _gather_weighted_sum(flat: torch.Tensor, idx_list, w_list
                         ) -> torch.Tensor:
    """sum_c w_c * flat[idx_c] through ONE :func:`gather_rows` call, so the
    backward is one scatter for every corner or tap (reference
    grid.py:51)."""
    C = len(idx_list)
    idx = torch.stack(idx_list, dim=0)
    w = torch.stack(w_list, dim=0)
    f = gather_rows(flat, idx.reshape(C, -1))
    f = f.reshape(*idx.shape, flat.shape[-1])
    return torch.sum(w[..., None] * f, dim=0)


def _grid_coords(x: torch.Tensor, G: int, vmin: Vec3, vmax: Vec3):
    """(continuous coords in [0, G-1] (..., 3), G-1 per axis (3,)) for a
    G-wide table on every axis."""
    g1 = _vec([G - 1] * 3, x)
    return _to_grid(x, g1, _vec(vmin, x), _vec(vmax, x)), g1


def _sinc(x: torch.Tensor) -> torch.Tensor:
    """sin(pi x) / (pi x).  Near 0 the quotient's derivative cancels (two
    terms of ~1/(pi x) whose difference is ~(pi x)/3), so there, for
    |pi x| < 0.1, the Maclaurin polynomial to (pi x)^6 stands in for it:
    the same value to 3e-14 relative, and derivatives that autograd takes
    without the cancellation.  ``torch.sinc`` and ``jnp.sinc`` both take
    the quotient's derivative: in f32, at a point 4e-5 from a node, a
    Lanczos triline query's d x then parts from its f64 value by up to
    3e-4 of its largest entry."""
    y = math.pi * x
    y2 = y * y
    small = y.abs() < 0.1
    safe = torch.where(small, torch.ones_like(y), y)
    poly = 1.0 - y2 / 6.0 * (1.0 - y2 / 20.0 * (1.0 - y2 / 42.0))
    return torch.where(small, poly, torch.sin(safe) / safe)


def lanczos_window(x: torch.Tensor, a: int = 2) -> torch.Tensor:
    """sinc(x) * sinc(x / a), with no |x| < a cutoff (reference
    grid.py:95, csrc/grid_feature/common.cuh:62-69)."""
    return _sinc(x) * _sinc(x / a)


def _lanczos_taps(xyz: torch.Tensor, g1: torch.Tensor, a: int):
    """Per axis, the 2a tap positions (int64, clamped to the table) and
    their coefficients, taken at the clamped positions.  ``floor(xyz)`` is
    not clamped before the offsets (reference grid.py:836)."""
    xyz0 = torch.floor(xyz).detach()
    pos, coef = [], []
    for ax in range(3):
        ps, cs = [], []
        for o in range(-a + 1, a + 1):
            p = torch.minimum(torch.clamp_min(xyz0[..., ax] + o, 0.0),
                              g1[..., ax])
            cs.append(lanczos_window(xyz[..., ax] - p, a))
            ps.append(p.long())
        pos.append(ps)
        coef.append(cs)
    return pos, coef


def query_voxel_lanczos(x: torch.Tensor, feature: torch.Tensor,
                        vmin: Vec3 = DEFAULT_MIN, vmax: Vec3 = DEFAULT_MAX,
                        a: int = 2) -> torch.Tensor:
    """Lanczos-a dense-grid query, (2a)^3 taps: (..., 3) -> (..., D)
    (reference grid.py:827).  A call on the card that builds no autograd
    graph (grad mode off, or neither ``x`` nor ``feature`` requiring grad)
    with f32 points and table, a = 2 and N*D outputs that PyTorch sums in
    the kernel's order is one launch of the gather kernel
    (:func:`~ndjir_torch.ops.lanczos_gather.lanczos_voxel_gather`), which
    gives the same bits; every other call takes the composite."""
    if x.is_cuda and a == 2 and x.dtype == feature.dtype == torch.float32 \
            and sums_in_warps(x.numel() // 3 * feature.shape[-1]) \
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or feature.requires_grad)):
        return lanczos_voxel_gather(x, feature, vmin, vmax)
    return _query_voxel_lanczos_composite(x, feature, vmin, vmax, a)


def _query_voxel_lanczos_composite(x: torch.Tensor, feature: torch.Tensor,
                                   vmin: Vec3, vmax: Vec3, a: int
                                   ) -> torch.Tensor:
    """:func:`query_voxel_lanczos` as PyTorch ops, differentiable in ``x``
    (twice) and in ``feature``."""
    Gx, Gy, Gz, D = feature.shape
    g1 = _vec([Gx - 1, Gy - 1, Gz - 1], x)
    xyz = _to_grid(x, g1, _vec(vmin, x), _vec(vmax, x))
    (px, cx), (py, cy), (pz, cz) = zip(*_lanczos_taps(xyz, g1, a))
    sy, sx = Gz, Gy * Gz
    idx_list, w_list = [], []
    for i in range(2 * a):
        for j in range(2 * a):
            wij = cx[i] * cy[j]
            base_ij = px[i] * sx + py[j] * sy
            for k in range(2 * a):
                idx_list.append(base_ij + pz[k])
                w_list.append(wij * cz[k])
    return _gather_weighted_sum(feature.reshape(-1, D), idx_list, w_list)


def init_triplane(generator: torch.Generator, G: int, D: int,
                  eps: float = 1e-3, dtype=torch.float32, device="cuda"
                  ) -> torch.Tensor:
    return eps * torch.randn((3, G, G, D), generator=generator, dtype=dtype,
                             device=device)


def _linear_corners(x, G, vmin, vmax, weight):
    """Clamped corner ids (int64) and weights, per axis, for a G-wide
    table: (i0, i1, w0, w1), each (..., 3)."""
    xyz, g1 = _grid_coords(x, G, vmin, vmax)
    xyz0, xyz1 = _corners(xyz, g1)
    w0, w1 = _weights(xyz, xyz0, xyz1, weight)
    return xyz0.detach().long(), xyz1.detach().long(), w0, w1


def query_triplane(x: torch.Tensor, feature: torch.Tensor,
                   vmin: Vec3 = DEFAULT_MIN, vmax: Vec3 = DEFAULT_MAX,
                   weight: str = "linear") -> torch.Tensor:
    """Sum of three bilinear plane queries: (..., 3) -> (..., D)
    (reference grid.py:877); the 12 taps read one (3G^2, D) table."""
    _, G, _, D = feature.shape
    i0, i1, w0, w1 = _linear_corners(x, G, vmin, vmax, weight)
    idx_list, w_list = [], []
    for p, (au, av) in enumerate(_PLANE_AXES):
        off = p * G * G
        for iu, wu in ((i0, w0), (i1, w1)):
            for iv, wv in ((i0, w0), (i1, w1)):
                idx_list.append(off + iu[..., au] * G + iv[..., av])
                w_list.append(wu[..., au] * wv[..., av])
    return _gather_weighted_sum(feature.reshape(-1, D), idx_list, w_list)


def query_triplane_lanczos(x: torch.Tensor, feature: torch.Tensor,
                           vmin: Vec3 = DEFAULT_MIN,
                           vmax: Vec3 = DEFAULT_MAX, a: int = 2
                           ) -> torch.Tensor:
    """Lanczos-a triplane query, (2a)^2 taps a plane (reference
    grid.py:906)."""
    _, G, _, D = feature.shape
    xyz, g1 = _grid_coords(x, G, vmin, vmax)
    pos, coef = _lanczos_taps(xyz, g1, a)
    idx_list, w_list = [], []
    for p, (au, av) in enumerate(_PLANE_AXES):
        off = p * G * G
        for i in range(2 * a):
            for j in range(2 * a):
                idx_list.append(off + pos[au][i] * G + pos[av][j])
                w_list.append(coef[au][i] * coef[av][j])
    return _gather_weighted_sum(feature.reshape(-1, D), idx_list, w_list)


def init_triline(generator: torch.Generator, G: int, D: int,
                 eps: float = 1e-3, dtype=torch.float32, device="cuda"
                 ) -> torch.Tensor:
    return eps * torch.randn((3, G, D), generator=generator, dtype=dtype,
                             device=device)


def query_triline(x: torch.Tensor, feature: torch.Tensor,
                  vmin: Vec3 = DEFAULT_MIN, vmax: Vec3 = DEFAULT_MAX,
                  weight: str = "linear") -> torch.Tensor:
    """Sum of three 1-D line queries: (..., 3) -> (..., D) (reference
    grid.py:941)."""
    _, G, D = feature.shape
    i0, i1, w0, w1 = _linear_corners(x, G, vmin, vmax, weight)
    idx_list, w_list = [], []
    for ax in range(3):
        for i, w in ((i0, w0), (i1, w1)):
            idx_list.append(ax * G + i[..., ax])
            w_list.append(w[..., ax])
    return _gather_weighted_sum(feature.reshape(-1, D), idx_list, w_list)


def query_triline_lanczos(x: torch.Tensor, feature: torch.Tensor,
                          vmin: Vec3 = DEFAULT_MIN, vmax: Vec3 = DEFAULT_MAX,
                          a: int = 2) -> torch.Tensor:
    """Lanczos-a triline query, 2a taps a line (reference grid.py:965)."""
    _, G, D = feature.shape
    xyz, g1 = _grid_coords(x, G, vmin, vmax)
    pos, coef = _lanczos_taps(xyz, g1, a)
    idx_list, w_list = [], []
    for ax in range(3):
        for p, c in zip(pos[ax], coef[ax]):
            idx_list.append(ax * G + p)
            w_list.append(c)
    return _gather_weighted_sum(feature.reshape(-1, D), idx_list, w_list)


# ---------------------------------------------------------------------------
# multi-resolution voxel hash
# ---------------------------------------------------------------------------

def init_voxel_hash(generator: torch.Generator, G0: int,
                    growth_factor: float, T0: int, L: int, D: int,
                    eps: float = 1e-3, dtype=torch.float32, device="cuda"
                    ) -> torch.Tensor:
    """Flat N(0, eps) parameter buffer (reference:
    voxel_hash_feature.py:230-237)."""
    n = hash_num_params(G0, growth_factor, T0, L, D)
    return eps * torch.randn((n,), generator=generator, dtype=dtype,
                             device=device)


def hash_index(x: torch.Tensor, G: int, T: int, vmin: Vec3 = DEFAULT_MIN,
               vmax: Vec3 = DEFAULT_MAX) -> torch.Tensor:
    """Debug op: the 8 hash-table ids of each query's cell corners,
    (..., 8), corner order x-major (x0y0z0, x0y0z1, ..., x1y1z1; reference
    grid.py:1041, kernel_hash_index)."""
    i0, i1, _, _ = _linear_corners(x, G, vmin, vmax, "linear")
    return torch.stack([_hash_index(cx[..., 0], cy[..., 1], cz[..., 2], T)
                        for cx in (i0, i1) for cy in (i0, i1)
                        for cz in (i0, i1)], dim=-1)


def query_voxel_hash(x: torch.Tensor, feature: torch.Tensor, G0: int = 16,
                     growth_factor: float = 1.5, T0: int = 2 ** 15,
                     L: int = 16, D: int = 2, vmin: Vec3 = DEFAULT_MIN,
                     vmax: Vec3 = DEFAULT_MAX) -> torch.Tensor:
    """Multi-resolution hash query: (..., 3) -> (..., D*L), channel
    d*L + l (reference grid.py:1073).  Vectorized over levels; the 8 x L
    lookups read the (n_params / D, D) view in ONE gather.  The forward is
    a program span, ``grid.hash_query``, carrying its ``points``,
    ``levels`` and table ``rows`` read."""
    n = x.numel() // 3
    with annotate("grid.hash_query", points=n, levels=L, rows=n * 8 * L):
        xyz, g1b, Ts, row0s = _hash_levels(x, G0, growth_factor, T0, L, D,
                                           vmin, vmax)
        xyz0, xyz1 = _corners(xyz, g1b)
        w0, w1 = _weights(xyz, xyz0, xyz1, "linear")
        i0, i1 = xyz0.detach().long(), xyz1.detach().long()
        idx_list, w_list = [], []
        for ix, wx in ((i0, w0), (i1, w1)):
            for iy, wy in ((i0, w0), (i1, w1)):
                for iz, wz in ((i0, w0), (i1, w1)):
                    idx_list.append(row0s + _hash_index(
                        ix[..., 0], iy[..., 1], iz[..., 2], Ts))
                    w_list.append(wx[..., 0] * wy[..., 1] * wz[..., 2])
        acc = _gather_weighted_sum(feature.reshape(-1, D), idx_list, w_list)
        return _levels_to_channels(acc, x)


def query_voxel_hash_lanczos(x: torch.Tensor, feature: torch.Tensor,
                             G0: int = 16, growth_factor: float = 1.5,
                             T0: int = 2 ** 15, L: int = 16, D: int = 2,
                             vmin: Vec3 = DEFAULT_MIN,
                             vmax: Vec3 = DEFAULT_MAX, a: int = 2
                             ) -> torch.Tensor:
    """Lanczos-a hash query, (2a)^3 taps a level (reference
    grid.py:1135); its forward is the span ``grid.hash_query`` as
    :func:`query_voxel_hash`'s, with (2a)^3 L rows a point."""
    n = x.numel() // 3
    with annotate("grid.hash_query", points=n, levels=L,
                  rows=n * (2 * a) ** 3 * L):
        xyz, g1b, Ts, row0s = _hash_levels(x, G0, growth_factor, T0, L, D,
                                           vmin, vmax)
        pos, coef = _lanczos_taps(xyz, g1b, a)
        idx_list, w_list = [], []
        for i in range(2 * a):
            for j in range(2 * a):
                wij = coef[0][i] * coef[1][j]
                for k in range(2 * a):
                    idx_list.append(row0s + _hash_index(
                        pos[0][i], pos[1][j], pos[2][k], Ts))
                    w_list.append(wij * coef[2][k])
        acc = _gather_weighted_sum(feature.reshape(-1, D), idx_list, w_list)
        return _levels_to_channels(acc, x)


# ---------------------------------------------------------------------------
# the encoding the networks consume
# ---------------------------------------------------------------------------

_FAMILIES = ("voxel", "triplane", "triline", "triplaneline")
_HASH_TYPES = ("voxel_hash", "lanczos_voxel_hash")


class GridEncoding:
    """Config-driven grid encoding: init(generator) -> params,
    apply(params, x) (reference grid.py:1191).  Types: ``none``,
    ``{,cosine_,lanczos_}{voxel,triplane,triline,triplaneline}``,
    ``voxel_hash`` and ``lanczos_voxel_hash``."""

    TYPES = ("none",) + tuple(f"{p}{f}" for p in ("", "cosine_", "lanczos_")
                              for f in _FAMILIES) + _HASH_TYPES

    def __init__(self, conf_voxel, radius: float = 1.0):
        c = conf_voxel
        self.type = c.type
        if self.type not in self.TYPES:
            raise ValueError(f"Unknown grid type: {self.type!r}; the types "
                             "are " + ", ".join(self.TYPES))
        self.G = int(c.grid_size)
        self.D = int(c.feature_size)
        self.use_ste = bool(c.use_ste)
        self.vmin = (-radius, -radius, -radius)
        self.vmax = (radius, radius, radius)
        self.hash_G0 = int(c.get("hash_base_grid_size", 16))
        self.hash_growth = float(c.get("hash_growth_factor", 1.5))
        self.hash_T0 = int(c.get("hash_table_size", 2 ** 15))
        self.hash_L = int(c.get("hash_levels", 16))
        self.kind = "cosine" if self.type.startswith("cosine_") else "linear"
        self.lanczos = self.type.startswith("lanczos_")
        # the layout: voxel, triplane, triline, triplaneline or voxel_hash
        self.family = ("voxel_hash" if self.type in _HASH_TYPES
                       else self.type.split("_")[-1])

    @property
    def out_dim(self) -> int:
        if self.type == "none":
            return 0
        if self.family == "voxel_hash":
            return self.D * self.hash_L
        if self.family == "triplaneline":
            return 2 * self.D
        return self.D

    @property
    def hash_args(self):
        return (self.hash_G0, self.hash_growth, self.hash_T0, self.hash_L,
                self.D)

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda"):
        """The leaves: ``F`` (``plane_F`` and ``line_F`` for
        triplaneline), N(0, 1e-3) in ``dtype``."""
        kw = dict(dtype=dtype, device=device)
        f = self.family
        if self.type == "none":
            return {}
        if f == "voxel_hash":
            return {"F": init_voxel_hash(generator, *self.hash_args, **kw)}
        if f == "triplaneline":
            return {"plane_F": init_triplane(generator, self.G, self.D, **kw),
                    "line_F": init_triline(generator, self.G, self.D, **kw)}
        init = {"triplane": init_triplane, "triline": init_triline,
                "voxel": init_voxel}[f]
        return {"F": init(generator, self.G, self.D, **kw)}

    def _x(self, x: torch.Tensor) -> torch.Tensor:
        # straight-through: the grid adds no d(feature)/dx to the normal /
        # eikonal double backward (reference voxel_feature.py:383-397);
        # feature gradients still flow
        return x.detach() if self.use_ste else x

    def apply_with_tv(self, params, x: torch.Tensor, sym_backward: bool = True):
        """(features, tv_map): from one shared corner gather on a dense
        linear or cosine voxel, else the query and :func:`grid_tv_loss`
        apart (reference grid.py:1254)."""
        if self.type in ("voxel", "cosine_voxel"):
            return query_voxel_and_tv(self._x(x), params["F"], self.vmin,
                                      self.vmax, self.kind, sym_backward,
                                      params.get("octa_table"))
        return (self.apply(params, x),
                grid_tv_loss(self, params, x, sym_backward))

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        if self.type == "none":
            raise ValueError("apply() on type='none'")
        x = self._x(x)
        box = (self.vmin, self.vmax)
        f = self.family
        if f == "voxel_hash":
            fn = query_voxel_hash_lanczos if self.lanczos \
                else query_voxel_hash
            return fn(x, params["F"], *self.hash_args, *box)
        if f == "triplaneline":
            return torch.cat([self._query("triplane", x, params["plane_F"]),
                              self._query("triline", x, params["line_F"])],
                             dim=-1)
        if f == "voxel" and not self.lanczos:
            return query_voxel(x, params["F"], *box, self.kind,
                               params.get("octa_table"))
        return self._query(f, x, params["F"])

    def _query(self, family: str, x: torch.Tensor, F: torch.Tensor):
        box = (self.vmin, self.vmax)
        if self.lanczos:
            fn = {"voxel": query_voxel_lanczos,
                  "triplane": query_triplane_lanczos,
                  "triline": query_triline_lanczos}[family]
            return fn(x, F, *box)
        fn = {"triplane": query_triplane, "triline": query_triline}[family]
        return fn(x, F, *box, self.kind)
