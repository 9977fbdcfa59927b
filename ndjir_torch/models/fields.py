"""Coordinate-MLP field networks (geometry, materials, lights, background).

Counterpart of ``ndjir_tpu/models/fields.py``.  Every network is a pair
``init_*(generator, conf, device) -> params`` / ``*_apply(params, ...,
conf) -> out`` over a plain dict of tensors whose keys are the reference's
parameter scopes (``geometric-network/affine-00/W`` ...), with (in, out)
affine weights, so params convert 1:1 from the reference
(:mod:`ndjir_torch.bridge`).  The full model is :func:`init_model`.

``precision.mlp_dtype=bfloat16`` runs every affine layer on bf16 operands
with f32 products and sums, the bias added in f32 and one rounding to the
stored dtype: bf16 for hidden activations, f32 for each network's last
layer (reference fields.py:52-72).  ``precision.grid_dtype=bfloat16`` keeps
the grid's tables in bf16; everything else stays f32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ndjir_torch.ops.activations import (
    get_activation,
    get_last_activation,
    softplus,
)
from ndjir_torch.ops.encoding import pe_dim, positional_encoding
from ndjir_torch.ops.grid import (
    GridEncoding,
    use_octa_layout,
    voxel_gather_multi,
    voxel_interp_octa,
    voxel_tv_octa,
)
from ndjir_torch.ops.octa_build import build_octa_table
from ndjir_torch.ops.ties import clip
from ndjir_torch.utils.profiling import annotate

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _precision(conf, key: str) -> torch.dtype:
    """``conf.precision.<key>`` as a torch dtype (float32 without the
    section); raises for a dtype the reference does not run."""
    name = conf.precision.get(key, "float32") if "precision" in conf \
        else "float32"
    if name not in _DTYPES:
        raise ValueError(f"precision.{key}={name!r}: the port runs "
                         f"{' or '.join(_DTYPES)}")
    return _DTYPES[name]


def check_precision(conf) -> None:
    """Raise for a precision the port does not run."""
    _precision(conf, "mlp_dtype")
    _precision(conf, "grid_dtype")


def _compute_dtype(conf) -> Optional[torch.dtype]:
    """The affine layers' operand dtype: None (f32 throughout) or bf16."""
    d = _precision(conf, "mlp_dtype")
    return None if d == torch.float32 else d


def param_dtype(path, conf) -> torch.dtype:
    """The dtype :func:`init_model` gives the leaf at key ``path``: every
    leaf of the geometric grid (``F``, ``plane_F``, ``line_F``) in
    ``precision.grid_dtype``, every other leaf f32 (reference
    fields.py:199-205)."""
    if tuple(path[:2]) == ("geometric-network", "grid"):
        return _precision(conf, "grid_dtype")
    return torch.float32


# ---------------------------------------------------------------------------
# affine + MLP primitives
# ---------------------------------------------------------------------------

def _glorot_uniform(gen, Di, Do, device):
    lim = math.sqrt(6.0 / (Di + Do))
    u = torch.rand((Di, Do), generator=gen, device=device)
    return (2.0 * u - 1.0) * lim


def init_affine(gen, Di: int, Do: int, use_wn: bool = False,
                device="cuda") -> Params:
    p = {"W": _glorot_uniform(gen, Di, Do, device),
         "b": torch.zeros((Do,), device=device)}
    if use_wn:
        p["g"] = torch.ones((Do,), device=device)
    return p


def _normalized_W(p: Params) -> torch.Tensor:
    """W, or g * W / ||W||_col under weight normalization
    (reference: python/network.py:88-93)."""
    W = p["W"]
    if "g" in p:
        W = p["g"] * W / clip(
            torch.linalg.norm(W, dim=0, keepdim=True), 1e-12)
    return W


class _MatmulBf16(torch.autograd.Function):
    """a (n, k) @ b (k, m) for bf16 a and b on the card: one cuBLAS product
    with f32 output (``torch.mm(..., out_dtype=float32)``), products exact
    and sums in f32.  The backward is the plain form's, in f32 and itself
    differentiable, for the eikonal double backward."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        ga = (g @ b.float().t()).to(a.dtype) \
            if ctx.needs_input_grad[0] else None
        gb = (a.float().t() @ g).to(b.dtype) \
            if ctx.needs_input_grad[1] else None
        return ga, gb


def _matmul(h: torch.Tensor, W: torch.Tensor, compute_dtype) -> torch.Tensor:
    """h (..., k) @ W (k, m) in f32.  With ``compute_dtype`` both operands
    are first rounded to it and the products summed in f32: on the CPU as
    an f32 product of the rounded values (exact products), on the card as
    an f32-output bf16 GEMM.  ``torch.matmul`` on bf16 operands would
    round the sums to bf16 before the bias is added, a second rounding
    the reference does not make (fields.py:71-72)."""
    if compute_dtype is None:
        return h @ W
    h, W = h.to(compute_dtype), W.to(compute_dtype)
    if h.is_cuda:
        y = _MatmulBf16.apply(h.reshape(-1, h.shape[-1]), W)
        return y.reshape(*h.shape[:-1], W.shape[-1])
    return h.float() @ W.float()


def affine_apply(p: Params, h: torch.Tensor, compute_dtype=None,
                 out_dtype=torch.float32) -> torch.Tensor:
    """y = h @ W + b (W optionally weight-normalized per output column),
    products summed in f32, the bias added in f32, one rounding to
    ``out_dtype``."""
    y = _matmul(h, _normalized_W(p), compute_dtype) + p["b"]
    return y.to(out_dtype)


def affine_apply_split(p: Params, parts, compute_dtype=None,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Affine over the conceptual concat of ``parts`` without building it:
    each part multiplies its own row block of W and the products add.  A
    part with a size-1 axis (a per-pixel input against per-sample ones) is
    projected once and broadcast at the layer's width."""
    W = _normalized_W(p)
    off, y = 0, None
    for t in parts:
        if t is None:
            continue
        d = _matmul(t, W[off:off + t.shape[-1]], compute_dtype)
        off += t.shape[-1]
        y = d if y is None else y + d
    if off != W.shape[0]:
        raise ValueError(f"parts are {off} wide, W has {W.shape[0]} rows")
    return (y + p["b"]).to(out_dtype)


def _mlp_init(gen, dims, use_wn, device, name_fmt="affine-{:02d}",
              name_offset=0, last_offset=None):
    """Plain MLP stack -> {name: affine params}.  ``last_offset`` shifts the
    last layer's number separately (the reference's roughness / specular
    heads, network.py:451, 454)."""
    last_offset = name_offset if last_offset is None else last_offset
    params = {}
    L = len(dims) - 1
    for l in range(L):
        off = last_offset if l == L - 1 else name_offset
        params[name_fmt.format(l + off)] = init_affine(
            gen, dims[l], dims[l + 1], use_wn=use_wn, device=device)
    return params


def _mlp_apply(params, h, n_layers, act, compute_dtype=None,
               name_fmt="affine-{:02d}", name_offset=0, last_offset=None,
               start=0):
    """``start``: resume from layer ``start`` (the caller applied the
    earlier layers, e.g. via :func:`affine_apply_split`).  Hidden
    activations are stored in ``compute_dtype`` (f32 without it), the last
    layer's output in f32."""
    last_offset = name_offset if last_offset is None else last_offset
    hid = torch.float32 if compute_dtype is None else compute_dtype
    for l in range(start, n_layers - 1):
        h = act(affine_apply(params[name_fmt.format(l + name_offset)], h,
                             compute_dtype, out_dtype=hid))
    return affine_apply(params[name_fmt.format(n_layers - 1 + last_offset)],
                        h, compute_dtype)


# ---------------------------------------------------------------------------
# geometric (SDF) network with SAL sphere init
# ---------------------------------------------------------------------------

def _geometric_w(gen, Di, Do, sigma, device, zero_start=None, last=False):
    """sqrt(sigma) * randn, optional zeroed row block, optional pi-scaled SDF
    column (reference GeometricInitializer, python/network.py:36-56)."""
    w = math.sqrt(sigma) * torch.randn((Di, Do), generator=gen, device=device)
    if zero_start is not None:
        zs = zero_start if zero_start >= 0 else Di + zero_start
        w[zs:] = 0.0
    if last:
        w[:, 0] = (math.sqrt(math.pi / Di)
                   + 1e-4 * torch.randn((Di,), generator=gen, device=device))
    return w


def init_geometric(gen, conf, device="cuda") -> Params:
    """SDF network params (reference: python/network.py:154-232).

    Under geometric_init (the default): layer 0 zeroes the weight rows of
    everything but raw x; the layer feeding a skip concat narrows to
    D - D_inputs; the skip layer zeroes the concatenated-input rows; the last
    layer ("affine-last") gets the pi-scaled SDF column and bias -r.
    """
    check_precision(conf)
    g = conf.geometric_network
    D, L, M = g.feature_size, g.layers, g.pe_bands
    skip_layers = tuple(g.skip_layers)
    use_wn = conf.use_wn

    enc = GridEncoding(g.voxel, radius=conf.renderer.bounding_sphere_radius)
    Dx = 3
    Din = pe_dim(Dx, M) + enc.out_dim  # width of the concatenated inputs

    params: Params = {}
    if enc.out_dim > 0:
        params["grid"] = enc.init(
            gen, dtype=param_dtype(("geometric-network", "grid"), conf),
            device=device)

    zeros = lambda n: torch.zeros((n,), device=device)  # noqa: E731
    if not g.geometric_init:
        h_dim = Din
        for l in range(L - 1):
            params[f"affine-{l:02d}"] = init_affine(gen, h_dim, D, use_wn,
                                                    device)
            h_dim = D + (pe_dim(Dx, M) if l in skip_layers else 0)
        params[f"affine-{L - 1:02d}"] = init_affine(gen, h_dim, D + 1,
                                                    use_wn, device)
    else:
        h_dim = Din
        for l in range(L):
            if l == 0:
                W = _geometric_w(gen, h_dim, D, 2.0 / D, device, zero_start=Dx)
                params[f"affine-{l:02d}"] = {"W": W, "b": zeros(D)}
                h_dim = D
            elif l in skip_layers:
                W = _geometric_w(gen, D, D, 2.0 / (D - Din), device,
                                 zero_start=-Din)
                params[f"affine-{l:02d}"] = {"W": W, "b": zeros(D)}
                h_dim = D
            elif l == L - 1:
                Do = 1 + D
                W = _geometric_w(gen, D, Do, 2.0 / Do, device, last=True)
                b = torch.full((Do,), -g.initial_sphere_radius, device=device)
                params["affine-last"] = {"W": W, "b": b}
            else:
                Do = D - Din if (l + 1) in skip_layers else D
                W = _geometric_w(gen, h_dim, Do, 2.0 / Do, device)
                params[f"affine-{l:02d}"] = {"W": W, "b": zeros(Do)}
                h_dim = Do + (Din if (l + 1) in skip_layers else 0)
            if use_wn:
                name = "affine-last" if l == L - 1 else f"affine-{l:02d}"
                params[name]["g"] = torch.ones(
                    params[name]["W"].shape[1:], device=device)

    # learnable NeuS inverse-s parameter (reference: network.py:227-231)
    params["gain"] = torch.tensor([conf.train.sigmoid_gain], device=device)
    return params


def geometric_apply(params: Params, x: torch.Tensor, conf,
                    with_tv: bool = False, tv_sym: bool = True):
    """x (..., 3) -> (sdf (..., 1), feature (..., D), gain (1,)), plus the
    grid TV map from the same corner gather when ``with_tv``."""
    g = conf.geometric_network
    tv_map = None
    pe_x = positional_encoding(x, g.pe_bands) if g.pe_bands > 0 else x
    if "grid" in params:
        enc = GridEncoding(g.voxel,
                           radius=conf.renderer.bounding_sphere_radius)
        if with_tv:
            vfeat, tv_map = enc.apply_with_tv(params["grid"], x, tv_sym)
        else:
            vfeat = enc.apply(params["grid"], x)
    else:
        if with_tv:
            tv_map = torch.zeros((*x.shape[:-1], 1), dtype=x.dtype,
                                 device=x.device)
        vfeat = None

    sdf, feature, gain = _geometric_mlp(params, pe_x, vfeat, conf)
    if with_tv:
        return sdf, feature, gain, tv_map
    return sdf, feature, gain


def _geometric_mlp(params: Params, pe_x: torch.Tensor, vfeat, conf):
    """The geometric MLP stack over PE'd inputs and grid features."""
    g = conf.geometric_network
    L = g.layers
    act = get_activation(g.act)
    skip_layers = tuple(g.skip_layers)
    cdt = _compute_dtype(conf)
    hid = torch.float32 if cdt is None else cdt

    inputs = pe_x if vfeat is None else torch.cat([pe_x, vfeat], dim=-1)
    h = inputs
    if not g.geometric_init:
        for l in range(L - 1):
            h = affine_apply(params[f"affine-{l:02d}"], h, cdt, out_dtype=hid)
            if l in skip_layers:
                h = torch.cat([h, pe_x.to(h.dtype)], dim=-1)
            h = act(h)
        h = affine_apply(params[f"affine-{L - 1:02d}"], h, cdt)
    else:
        for l in range(L):
            name = "affine-last" if l == L - 1 else f"affine-{l:02d}"
            h = affine_apply(params[name], h, cdt,
                             out_dtype=torch.float32 if l == L - 1 else hid)
            if l < L - 1:
                h = act(h)
                # the skip concat only follows INTERMEDIATE layers (the
                # reference's first/skip branches never concat,
                # network.py:196-224)
                if (l + 1) in skip_layers and l != 0 \
                        and l not in skip_layers:
                    h = torch.cat([h, inputs.to(h.dtype)], dim=-1)
                    if g.use_inv_square:
                        h = h / math.sqrt(2)

    sdf, feature = h[..., 0:1], h[..., 1:]
    gain = clip(torch.exp(params["gain"] * 10.0), 1e-6, 5e4)
    return sdf, feature, gain


def geometric_supports_shared_gather(params: Params, conf) -> bool:
    """Whether the geometric network's grid takes the octa layout, so that
    several point sets can share one corner gather (and one backward) via
    :func:`geometric_gather_corners` (reference fields.py:329)."""
    g = conf.geometric_network
    if "grid" not in params or g.voxel.type not in ("voxel", "cosine_voxel") \
            or g.voxel.use_ste:
        return False
    F = params["grid"]["F"]
    return use_octa_layout(F.shape, F.dtype)


def _vbox(conf):
    r = conf.renderer.bounding_sphere_radius
    return (-r,) * 3, (r,) * 3


def geometric_gather_corners(params: Params, x_list, conf):
    """Octa rows for several point sets from ONE gather; pair with
    :func:`geometric_apply_corners` (reference fields.py:343)."""
    return voxel_gather_multi(x_list, params["grid"]["F"], *_vbox(conf),
                              params["grid"].get("octa_table"))


def with_octa_table(params: Params, conf) -> Params:
    """A shallow copy of the full model ``params`` whose geometric grid
    carries its prebuilt octa table as ``grid["octa_table"]`` (one B3
    launch on the card), for inference over a frozen table: every grid
    query then reads one row of it per point, as the JAX package's forward
    does (grid.py:548).  ``params`` itself when the grid does not take the
    octa layout (:func:`geometric_supports_shared_gather`; an f32 grid
    never does) or already carries its table.  The copy holds the only
    reference to the table, so it is freed with the copy.  The build is
    the program span ``grid.octa_build``, carrying the table's ``rows``."""
    geo = params.get("geometric-network", {})
    if not geometric_supports_shared_gather(geo, conf) \
            or "octa_table" in geo["grid"]:
        return params
    grid = geo["grid"]
    F = grid["F"]
    with torch.no_grad(), annotate("grid.octa_build",
                                   rows=F.numel() // F.shape[-1]):
        table = build_octa_table(F)
    geo = dict(geo, grid=dict(grid, octa_table=table))
    return dict(params, **{"geometric-network": geo})


def geometric_apply_corners(params: Params, x: torch.Tensor,
                            corners: torch.Tensor, conf,
                            with_tv: bool = False, tv_sym: bool = True):
    """:func:`geometric_apply` with the grid's octa rows supplied by the
    caller (reference fields.py:353).  The interpolation weights come from
    ``x``, so a spatial gradient over this function sees weight arithmetic
    only; the rows carry the table's gradient through the shared gather."""
    g = conf.geometric_network
    kind = "cosine" if g.voxel.type.startswith("cosine_") else "linear"
    pe_x = positional_encoding(x, g.pe_bands) if g.pe_bands > 0 else x
    vfeat = voxel_interp_octa(x, corners, params["grid"]["F"].shape,
                              *_vbox(conf), kind)
    sdf, feature, gain = _geometric_mlp(params, pe_x, vfeat, conf)
    if with_tv:
        return sdf, feature, gain, voxel_tv_octa(corners, x.dtype, tv_sym)
    return sdf, feature, gain


# ---------------------------------------------------------------------------
# generic material / light heads
# ---------------------------------------------------------------------------

def _head_inputs(x, feature, normal, use_feature, use_normal, extra=None):
    """Input PARTS for a head net, in the reference's concat order
    (x, extra, feature, normal)."""
    inputs = [x]
    if extra is not None:
        inputs.append(extra)
    if use_feature:
        inputs.append(feature)
    if use_normal:
        inputs.append(normal)
    return inputs


def _head_apply(params, parts, n_layers, act, compute_dtype=None,
                name_offset=0, last_offset=None):
    """Head MLP with a split (concat-free) first affine."""
    last_offset = name_offset if last_offset is None else last_offset
    if n_layers == 1:
        return affine_apply_split(params["affine-{:02d}".format(last_offset)],
                                  parts, compute_dtype)
    hid = torch.float32 if compute_dtype is None else compute_dtype
    h = act(affine_apply_split(params["affine-{:02d}".format(name_offset)],
                               parts, compute_dtype, out_dtype=hid))
    return _mlp_apply(params, h, n_layers, act, compute_dtype,
                      name_offset=name_offset, last_offset=last_offset,
                      start=1)


def _in_dim(conf, c, *extra):
    return 3 + sum(extra) \
        + (conf.geometric_network.feature_size
           if c.use_geometric_feature else 0) \
        + (3 if c.use_normal else 0)


def init_base_color(gen, conf, device="cuda") -> Params:
    c = conf.base_color_network
    dims = [_in_dim(conf, c)] + [c.feature_size] * (c.layers - 1) + [3]
    return _mlp_init(gen, dims, conf.use_wn, device)


def base_color_apply(params, x, feature, normal, conf):
    c = conf.base_color_network
    parts = _head_inputs(x, feature, normal, c.use_geometric_feature,
                         c.use_normal)
    return torch.sigmoid(_head_apply(params, parts, c.layers,
                                     get_activation(c.act),
                                     _compute_dtype(conf)))


def init_environment_light(gen, conf, device="cuda") -> Params:
    c = conf.environment_light_network
    dims = [pe_dim(3, c.pe_bands)] + [c.feature_size] * (c.layers - 1) \
        + [c.channels]
    return _mlp_init(gen, dims, conf.use_wn, device)


def environment_light_apply(params, light_dirs, conf):
    c = conf.environment_light_network
    h = positional_encoding(light_dirs, c.pe_bands) if c.pe_bands > 0 \
        else light_dirs
    h = _mlp_apply(params, h, c.layers, get_activation(c.act),
                   _compute_dtype(conf))
    out = get_last_activation(c.act_last, c.inverse_black_degree)(h)
    if c.upper_bound > 0:
        out = clip(out, 0.0, c.upper_bound)
    return out


def init_implicit_illumination(gen, conf, device="cuda") -> Optional[Params]:
    c = conf.implicit_illumination_network
    if not c.use_me:
        return None
    dims = [_in_dim(conf, c)] + [c.feature_size] * (c.layers - 1) \
        + [c.channels]
    return _mlp_init(gen, dims, conf.use_wn, device)


def implicit_illumination_apply(params, x, feature, normal, conf):
    c = conf.implicit_illumination_network
    if not c.use_me:
        return torch.zeros((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
    parts = _head_inputs(x, feature, normal, c.use_geometric_feature,
                         c.use_normal)
    h = _head_apply(params, parts, c.layers, get_activation(c.act),
                    _compute_dtype(conf))
    return get_last_activation(c.act_last, c.inverse_black_degree)(h)


def init_soft_visibility(gen, conf, device="cuda") -> Params:
    c = conf.soft_visibility_light_network
    dims = [_in_dim(conf, c, pe_dim(3, c.pe_bands))] \
        + [c.feature_size] * (c.layers - 1) + [c.channels]
    return _mlp_init(gen, dims, conf.use_wn, device)


def soft_visibility_apply(params, x, light_dirs, feature, normal, conf):
    """x / feature / normal may be per-pixel (..., 1, D) against per-dir
    (..., M, P) light dirs: the split first affine projects them once."""
    c = conf.soft_visibility_light_network
    pe_l = positional_encoding(light_dirs, c.pe_bands) if c.pe_bands > 0 \
        else light_dirs
    parts = _head_inputs(x, feature, normal, c.use_geometric_feature,
                         c.use_normal, extra=pe_l)
    h = _head_apply(params, parts, c.layers, get_activation(c.act),
                    _compute_dtype(conf))
    return get_last_activation(c.act_last, c.inverse_black_degree)(h)


def init_photogrammetric(gen, conf, device="cuda") -> Optional[Params]:
    c = conf.photogrammetric_light_network
    if not c.use_me:
        return None
    Din = 3 + pe_dim(3, c.pe_bands) + conf.geometric_network.feature_size + 3 \
        + (1 if c.use_inverse_distance else 0)
    dims = [Din] + [c.feature_size] * (c.layers - 1) + [c.channels]
    return _mlp_init(gen, dims, conf.use_wn, device)


def photogrammetric_apply(params, x, camloc, view, feature, normal, lv_gain,
                          conf):
    """Camera-attached ("flash") light visibility.  x (B, R, N, 3); camloc
    (B, 1, 3) or (B, 3); view (B, R, 1, 3); lv_gain the scheduled scalar
    (reference: network.py:418-422 + solver.py:110-119)."""
    c = conf.photogrammetric_light_network
    B, R, N, _ = x.shape
    pe_view = positional_encoding(view, c.pe_bands) if c.pe_bands > 0 \
        else view
    parts = [x, pe_view, feature, normal]
    if c.use_inverse_distance:
        dist2 = torch.sum((x - camloc.reshape(B, 1, 1, 3)) ** 2, dim=-1,
                          keepdim=True)
        parts.append(1.0 / (dist2 + 1e-5))
    h = _head_apply(params, parts, c.layers, get_activation(c.act),
                    _compute_dtype(conf))
    return torch.sigmoid(lv_gain * h)


def init_roughness(gen, conf, device="cuda") -> Params:
    c = conf.roughness_network
    dims = [_in_dim(conf, c)] + [c.feature_size] * (c.layers - 1) + [2]
    # parity quirk: hidden layers are named affine-{l-1} in the reference
    # (network.py:451) but the LAST layer is affine-{L-1}, so for L=4 the
    # keys are affine--1, affine-00, affine-01, affine-03
    return _mlp_init(gen, dims, conf.use_wn, device, name_offset=-1,
                     last_offset=0)


def roughness_apply(params, x, feature, normal, conf):
    c = conf.roughness_network
    parts = _head_inputs(x, feature, normal, c.use_geometric_feature,
                         c.use_normal)
    h = _head_apply(params, parts, c.layers, get_activation(c.act),
                    _compute_dtype(conf), name_offset=-1, last_offset=0)
    h0, h1 = h[..., 0:1], h[..., 1:2]
    std = softplus(h1)
    r = torch.sigmoid(h0)
    if conf.specular_brdf.model == "filament" and conf.specular_brdf.remap:
        r = r ** 2
    r = clip(r, c.lower_bound, 1.0)
    return r, std


def init_specular_reflectance(gen, conf, device="cuda") -> Optional[Params]:
    c = conf.specular_reflectance_network
    if c.fixme:
        return None
    dims = [_in_dim(conf, c)] + [c.feature_size] * (c.layers - 1) \
        + [c.channels * 2]
    return _mlp_init(gen, dims, conf.use_wn, device, name_offset=-1,
                     last_offset=0)


def specular_reflectance_apply(params, x, feature, normal, conf):
    c = conf.specular_reflectance_network
    Do = c.channels
    if c.fixme:
        v = torch.full((*x.shape[:-1], Do), 0.04, dtype=x.dtype,
                       device=x.device)
        return v, torch.ones_like(v)
    parts = _head_inputs(x, feature, normal, c.use_geometric_feature,
                         c.use_normal)
    h = _head_apply(params, parts, c.layers, get_activation(c.act),
                    _compute_dtype(conf), name_offset=-1, last_offset=0)
    # the reference splits (h[..., :-Do], h[..., Do:]): first Do, last Do
    h0, h1 = h[..., :Do], h[..., Do:]
    std = softplus(h1)
    v = torch.sigmoid(h0)
    if conf.specular_brdf.model == "filament" and conf.specular_brdf.remap:
        v = 0.16 * v ** 2
    else:
        v = c.upper_bound_scale * v
    return v, std


def init_background(gen, conf, device="cuda") -> Optional[Params]:
    if not conf.background_modeling:
        return None
    c = conf.background_network
    geo_dims = [pe_dim(4, c.pe_bands0)] + [c.feature_size0] * (c.layers0 - 1) \
        + [c.feature_size0 + 1]
    light_in = 4 + c.feature_size0 + 3 \
        + (pe_dim(3, c.pe_bands1) if c.pe_bands1 > 0 else 0)
    light_dims = [light_in] + [c.feature_size1] * (c.layers1 - 1) + [3]
    return {
        "geometric-network": _mlp_init(gen, geo_dims, conf.use_wn, device),
        "lighting-network": _mlp_init(gen, light_dims, conf.use_wn, device),
    }


def background_apply(params, x, view, delta, conf):
    """NeRF++ background: x (B, R, N, 4) 4D reparam, view (B, R, 1, 3),
    delta (B, R, N, 1) -> (alpha, color) (reference: network.py:512-561)."""
    c = conf.background_network
    act = get_activation(c.act)
    cdt = _compute_dtype(conf)
    B, R, N, _ = x.shape

    h = positional_encoding(x, c.pe_bands0) if c.pe_bands0 > 0 else x
    h = _mlp_apply(params["geometric-network"], h, c.layers0, act, cdt)
    density, feature = softplus(h[..., 0:1], beta=100), h[..., 1:]
    alpha = 1.0 - torch.exp(-density * delta)

    view = view.expand(B, R, N, 3)
    if c.pe_bands1 > 0:
        pe_view = positional_encoding(view, c.pe_bands1)
        h = torch.cat([x, feature, view, pe_view], dim=-1)
    else:
        h = torch.cat([x, feature, view], dim=-1)
    h = _mlp_apply(params["lighting-network"], h, c.layers1, act, cdt)
    return alpha, torch.sigmoid(h)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

_INITS = {
    "geometric-network": init_geometric,
    "base-color-network": init_base_color,
    "environment-light-network": init_environment_light,
    "implicit-illumination-network": init_implicit_illumination,
    "soft-visibility-light-network": init_soft_visibility,
    "photogrammetric-light-network": init_photogrammetric,
    "roughness-network": init_roughness,
    "specular-reflectance-network": init_specular_reflectance,
    "background-network": init_background,
}


def init_model(conf, seed: int = 0, device="cuda") -> Params:
    """The complete parameter tree for a config, drawn from one
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params: Params = {}
    for name, fn in _INITS.items():
        p = fn(gen, conf, device)
        if p is not None:
            params[name] = p
    return params


def is_grid_feature_path(path) -> bool:
    """True for grid-feature leaves (the reference's ``*feature/F`` split,
    solver.py:39-43); ``path`` is the tuple of keys down to the leaf."""
    return any(n in ("F", "plane_F", "line_F") for n in path)
