"""Ray point sampling: stratified + NeuS hierarchical importance + background.

Counterpart of ``ndjir_tpu/render/sampler.py``.  Sampling is data
generation, not part of the differentiated graph: :func:`sample_points` runs
under ``torch.no_grad()`` (the reference makes it a non-differentiable
PythonFunction, reference python/sampler.py:24-314).  With
``renderer.proposal_method: coarse_grid`` the proposal SDF values are
trilinear reads of a cached G_c^3 snapshot (:func:`make_proposal_grid`,
refreshed on the trainer's cadence) instead of geometric-network
evaluations; ``renderer.proposal_grid_bf16`` reads the grid in bf16.

Shapes (B rays-batch, R rays, N0 stratified, M per upsample, U rounds, Nb bg):
  x_fg (B, R, N0+M*U, 3); t_fg (B, R, N0+M*U+1, 1);
  x_bg (B, R, Nb, 4);     t_bg (B, R, Nb+1, 1);   hit mask (B, R, 1, 1).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ndjir_torch.models.fields import geometric_apply
from ndjir_torch.ops.grid import query_voxel
from ndjir_torch.ops.intersect import (
    ray_aabb_intersection,
    ray_sphere_intersection,
)


def _exclusive_cumprod_plain(x: torch.Tensor, dim: int) -> torch.Tensor:
    cp = torch.cumprod(x, dim=dim)
    one = torch.ones_like(cp.narrow(dim, 0, 1))
    return torch.cat([one, cp.narrow(dim, 0, x.shape[dim] - 1)], dim=dim)


def _shift_down(t: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """t[k + d] at k along ``dim``, 0 past the end."""
    n = t.shape[dim]
    if d >= n:
        return torch.zeros_like(t)
    return torch.cat([t.narrow(dim, d, n - d),
                      torch.zeros_like(t.narrow(dim, 0, d))], dim=dim)


class _ExclusiveCumprod(torch.autograd.Function):
    """y_i = prod_{j<i} x_j along ``dim``.  Its backward is
    dL/dx_k = y_k * S_k with S_k = sum_{i>k} g_i prod_{k<j<i} x_j, the
    reverse recurrence S_k = g_{k+1} + x_{k+1} S_{k+1} taken by pointer
    doubling: exact where x holds zeros, without a division and without
    the host read that torch's cumprod backward makes to look for zeros
    (a wait on the card, which a CUDA graph cannot capture).  The backward
    is built of differentiable ops."""

    @staticmethod
    def forward(ctx, x, dim):
        y = _exclusive_cumprod_plain(x, dim)
        ctx.save_for_backward(x, y)
        ctx.dim = dim
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        dim = ctx.dim
        a, s = _shift_down(x, 1, dim), _shift_down(g, 1, dim)
        d = 1
        while d < x.shape[dim]:
            s = s + a * _shift_down(s, d, dim)
            a = a * _shift_down(a, d, dim)
            d *= 2
        return y * s, None


def _exclusive_cumprod(x: torch.Tensor, dim: int) -> torch.Tensor:
    """cumprod with exclusive semantics (first element = 1)."""
    return _ExclusiveCumprod.apply(x, dim % x.ndim)


def t_near_far(camloc: torch.Tensor, raydir: torch.Tensor, conf):
    """Dispatch over the four t-range methods (reference: sampler.py:71-138).
    Returns t_near/t_far (B, R, 1) and hit mask (B, R, 1)."""
    method = conf.renderer.t_near_far_method
    radius = conf.renderer.bounding_sphere_radius
    B, R, _ = raydir.shape
    ones = torch.ones((B, R, 1), dtype=camloc.dtype, device=camloc.device)
    if method == "intersect_with_r_sphere":
        t_near, t_far, n_hits = ray_sphere_intersection(camloc, raydir, radius)
        mask = (n_hits > 1.0).to(camloc.dtype)
    elif method == "intersect_with_aabb":
        t_near, t_far, n_hits = ray_aabb_intersection(
            camloc, raydir, [-radius] * 3, [radius] * 3)
        mask = (n_hits > 1.0).to(camloc.dtype)
    elif method == "intersect_with_midpoint":
        cv = torch.sum(camloc[:, None, :] * raydir, dim=-1, keepdim=True)
        midpoint = -cv  # raydir is unit
        t_near = torch.clamp_min(midpoint - radius, 0.0)
        t_far = midpoint + radius
        mask = ones
    elif method == "intersect_with_camloc_dists":
        t_near, t_far = _camloc_dists_range(camloc, raydir, radius)
        mask = ones
    else:
        raise ValueError(f"Unsupported t_near_far method: {method}")
    return t_near, t_far, mask


def _camloc_dists_range(camloc, raydir, radius):
    B, R, _ = raydir.shape
    d = torch.linalg.norm(camloc, dim=-1, keepdim=True)[:, None, :]
    return (d - radius).expand(B, R, 1), (d + radius).expand(B, R, 1)


def sample_stratified(t_near, t_far, stratified_u, n_samples0):
    """t_i = t_near + step * (i + u_i), step = (t_far - t_near) / N
    (reference: sampler.py:140-165)."""
    B, R, _ = t_far.shape
    N = n_samples0
    tn = t_near.reshape(B, R, 1, 1)
    tf = t_far.reshape(B, R, 1, 1)
    step = (tf - tn) / N
    i = torch.arange(N, dtype=t_near.dtype,
                     device=t_near.device).reshape(1, 1, N, 1)
    return tn + step * (i + stratified_u)


def _proposal_sdf(params, conf, camloc, raydir, t):
    """SDF at sample positions t (proposal data generation)."""
    B, R = t.shape[:2]
    x = camloc.reshape(B, 1, 1, 3) + t * raydir.reshape(B, R, 1, 3)
    sdf, _, _ = geometric_apply(params["geometric-network"], x, conf)
    return sdf


def _propose_t(conf, t, sdf, t_near, t_far, gain, u):
    """One NeuS hierarchical proposal round (reference: sampler.py:189-241):
    t (B, R, Nt, 1) sorted with its SDF values -> M new positions
    (B, R, M, 1)."""
    B, R, Nt, _ = t.shape
    M = conf.renderer.n_samples1

    # robust section slope: clamped min of this and previous section's cos
    sdf0, sdf1 = sdf[:, :, :-1, :], sdf[:, :, 1:, :]
    t0, t1 = t[:, :, :-1, :], t[:, :, 1:, :]
    sdfm = 0.5 * (sdf0 + sdf1)
    cos_val1 = (sdf1 - sdf0) / (t1 - t0 + 1e-5)
    cos_val0 = torch.cat([torch.ones_like(cos_val1[:, :, :1]),
                          cos_val1[:, :, :-1, :]], dim=2)
    cos_val = torch.minimum(cos_val0, cos_val1)
    cos_val = torch.clamp(cos_val, -1e3, 0.0)

    dist = t1 - t0
    s0 = sdfm - cos_val * dist * 0.5
    s1 = sdfm + cos_val * dist * 0.5

    cdf0 = torch.sigmoid(s0 * gain)
    cdf1 = torch.sigmoid(s1 * gain)
    alpha = torch.clamp((cdf0 - cdf1 + 1e-5) / (cdf0 + 1e-5), 0.0, 1.0)
    weights = (alpha * _exclusive_cumprod(1.0 - alpha, dim=2))[..., 0]

    # inverse-transform sampling over normalized section weights
    weights = weights / torch.sum(weights, dim=2, keepdim=True)
    cumsum = torch.cumsum(weights, dim=2)
    if conf.renderer.deterministic:
        uu = torch.arange(M, dtype=t.dtype, device=t.device) \
            / (M - 1 + 1.0 / M)  # in [0, 1)
        uu = uu.reshape(1, 1, M).expand(B, R, M)
    else:
        if u is None:
            raise ValueError(
                "renderer.deterministic=false needs per-round uniforms; "
                "pass cdfs['upsample'] as rand_u (see make_mc_cdfs)")
        uu = u
    # the section index is #{cumsum[i] < u}, a comparison count (what
    # searchsorted(side='left') returns), with the reference's exact
    # semantics at bin edges
    idx = torch.sum(cumsum[:, :, :, None] < uu[:, :, None, :], dim=2)
    idx = torch.clamp_max(idx, Nt - 2)
    # per-section lookups as one-hot masked sums, as the reference takes
    # them (a NaN in any section propagates the same way)
    sec = torch.arange(Nt - 1, device=t.device).reshape(1, 1, Nt - 1, 1)
    onehot = (idx[:, :, None, :] == sec).to(t.dtype)  # (B, R, Nt-1, M)

    def take(v):  # v: (B, R, Nt-1) -> (B, R, M)
        return torch.sum(v[:, :, :, None] * onehot, dim=2)

    denorm = take(weights)
    lower = take(torch.cat([torch.zeros_like(cumsum[:, :, :1]),
                            cumsum[:, :, :-1]], dim=2))
    ratio = ((uu - lower) / denorm).reshape(B, R, M, 1)

    steps_idx = take(t[:, :, 1:, 0] - t[:, :, :-1, 0]).reshape(B, R, M, 1)
    ts_idx = take(t[:, :, :-1, 0]).reshape(B, R, M, 1)

    t_new = ts_idx + steps_idx * ratio
    return torch.minimum(torch.maximum(t_new, t_near.reshape(B, R, 1, 1)),
                         t_far.reshape(B, R, 1, 1))


def _merge_sorted(t, sdf, t_new, sdf_new):
    """Merge (t, sdf) with the new samples, kept sorted by t (stable)."""
    tc = torch.cat([t, t_new], dim=2)[..., 0]
    sc = torch.cat([sdf, sdf_new], dim=2)[..., 0]
    ts, perm = torch.sort(tc, dim=2, stable=True)
    return ts[..., None], torch.gather(sc, 2, perm)[..., None]


# the JAX package's bound on the f32 bytes of a grid that the proposal
# sampler reads as a bf16 copy (sampler.py:214)
_PROPOSAL_BF16_MAX_BYTES = 600_000_000


def _proposal_params(params, conf):
    """``params`` with the geometric grid read in bf16 when
    ``renderer.proposal_grid_bf16`` is on and the grid's f32 bytes are at
    most 600 MB (reference sampler.py:207-219): the copy costs a table
    read and write, worth it only for a small table.  A bf16 table is
    used as it is."""
    geo = params.get("geometric-network", {})
    if not conf.renderer.get("proposal_grid_bf16", False) \
            or "grid" not in geo:
        return params
    grid = geo["grid"]
    if sum(4 * f.numel() for f in grid.values()) > _PROPOSAL_BF16_MAX_BYTES:
        return params
    geo = dict(geo, grid={k: f.to(torch.bfloat16) for k, f in grid.items()})
    return dict(params, **{"geometric-network": geo})


def sample_importance(params, conf, camloc, raydir, t_near, t_far, t,
                      rand_u=None, sdf_fn=None):
    """U rounds of hierarchical upsampling with gain 64 * 2^u
    (reference: sampler.py:167-242).  SDF values are evaluated once per
    position and carried through the merge-sorts, so round u evaluates only
    the M new positions of round u-1 (same values as re-evaluating all).
    ``sdf_fn(t)`` overrides the proposal SDF source (the coarse grid); by
    default it is the geometric network."""
    if sdf_fn is None:
        params = _proposal_params(params, conf)

        def sdf_fn(t_):
            return _proposal_sdf(params, conf, camloc, raydir, t_)

    U = conf.renderer.n_upsamples
    base_gain = conf.renderer.sampling_sigmoid_gain
    sdf = sdf_fn(t)
    for u in range(U):
        uu = None if rand_u is None else rand_u[u]
        t_new = _propose_t(conf, t, sdf, t_near, t_far, base_gain * 2 ** u, uu)
        if u < U - 1:
            t, sdf = _merge_sorted(t, sdf, t_new, sdf_fn(t_new))
        else:
            # the final round's new positions never need an SDF value
            t = torch.sort(torch.cat([t, t_new], dim=2), dim=2)[0]
    return t


def sample_background(t_base, background_u):
    """Inverse-distance background samples t = t_base / u, sorted
    (reference: sampler.py:244-254)."""
    B, R, _ = t_base.shape
    return torch.sort(t_base.reshape(B, R, 1, 1) / background_u, dim=2)[0]


# points of the G_c^3 lattice evaluated per geometric-network call while
# a snapshot is built: bounds the MLP's activations (G_c=64 is 262,144
# points, ~0.27 GB per 256-wide f32 layer at once)
_SNAPSHOT_CHUNK = 65536


@torch.no_grad()
def make_proposal_grid(params, conf) -> torch.Tensor:
    """SDF snapshot (G_c, G_c, G_c, 1) on the lattice ``linspace(-r, r,
    G_c)``^3 over the bounding box (reference: sampler.py:243): the
    coarse-grid proposal's table, ``G_c = renderer.proposal_grid_size``.
    Built under ``no_grad`` in chunks of points, so it keeps no graph and
    its grid queries launch no scatter."""
    geo = params["geometric-network"]
    Gc = int(conf.renderer.get("proposal_grid_size", 64))
    r = conf.renderer.bounding_sphere_radius
    lin = torch.linspace(-r, r, Gc, dtype=torch.float32,
                         device=geo["gain"].device)
    pts = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"),
                      dim=-1).reshape(-1, 3)
    sdf = torch.cat([geometric_apply(geo, pts[i:i + _SNAPSHOT_CHUNK],
                                     conf)[0]
                     for i in range(0, len(pts), _SNAPSHOT_CHUNK)])
    return sdf.reshape(Gc, Gc, Gc, 1)


def _coarse_grid_sdf_fn(proposal_grid, conf, camloc, raydir):
    """Proposal SDF from trilinear reads of the snapshot over (-r, r)^3
    (reference: sampler.py:263)."""
    r = conf.renderer.bounding_sphere_radius
    B, R, _ = raydir.shape

    def sdf_fn(t_):
        x = camloc.reshape(B, 1, 1, 3) + t_ * raydir.reshape(B, R, 1, 3)
        return query_voxel(x, proposal_grid, (-r,) * 3, (r,) * 3)

    return sdf_fn


@torch.no_grad()
def sample_points(params, camloc, raydir, stratified_u, background_u, conf,
                  rand_u=None, proposal_grid=None) -> Tuple[torch.Tensor, ...]:
    """Full point-sampling pass (reference: sampler.py:276); returns
    (x_fg, t_fg, x_bg, t_bg, mask).  With ``renderer.proposal_method:
    coarse_grid`` and a ``proposal_grid`` from :func:`make_proposal_grid`
    the proposals read the snapshot; with no grid they run the network."""
    sdf_fn = None
    if (conf.renderer.get("proposal_method", "network") == "coarse_grid"
            and proposal_grid is not None):
        sdf_fn = _coarse_grid_sdf_fn(proposal_grid, conf, camloc, raydir)
    B, R, _ = raydir.shape
    t_near, t_far, mask = t_near_far(camloc, raydir, conf)
    t = sample_stratified(t_near, t_far, stratified_u,
                          conf.renderer.n_samples0)
    t = sample_importance(params, conf, camloc, raydir, t_near, t_far, t,
                          rand_u, sdf_fn)

    x_fg = camloc.reshape(B, 1, 1, 3) + t * raydir.reshape(B, R, 1, 3)
    t_fg = torch.cat([t, t_far.reshape(B, R, 1, 1)], dim=2)

    if conf.background_modeling:
        radius = conf.renderer.bounding_sphere_radius
        t_near_bg, _ = _camloc_dists_range(camloc, raydir, radius)
        t_base = t_far * mask + t_near_bg * (1.0 - mask)
        t_bg = sample_background(t_base, background_u)
        x_bg3 = camloc.reshape(B, 1, 1, 3) \
            + t_bg[:, :, :-1, :] * raydir.reshape(B, R, 1, 3)
        dists = torch.linalg.norm(x_bg3, dim=3, keepdim=True) + 1e-6
        x_bg = torch.cat([x_bg3 / dists, 1.0 / dists], dim=-1)
    else:
        Nb = conf.renderer.n_bg_samples
        x_bg = torch.ones((B, R, Nb, 4), dtype=camloc.dtype,
                          device=camloc.device)
        t_bg = torch.ones((B, R, Nb + 1, 1), dtype=camloc.dtype,
                          device=camloc.device)

    return x_fg, t_fg, x_bg, t_bg, mask.reshape(B, R, 1, 1)
