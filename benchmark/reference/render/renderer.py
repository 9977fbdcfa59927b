"""Physically-based volumetric renderer (counterpart of
``ndjir_tpu/render/renderer.py``; reference python/renderer.py:32-209).

Pipeline: SDF + feature + normal at fg samples -> NeuS section alpha with
annealed iter_cos -> NeRF++ background alpha -> joint transmittance ->
volume-rendered pixel quantities -> hemisphere-MC diffuse light (env x soft
visibility x cos + implicit illumination) -> GGX importance-sampled specular
-> photogrammetric-light composition -> + background.

The normal is ∇ₓ sdf from ``torch.autograd.grad(..., create_graph=True)``,
so the eikonal term's gradient is a true double backward.  The base-color
prior re-queries the geometric network at perturbed points: on an octa
table both point sets share one grid gather, so the step's backward makes
one B1 and one B2 launch (reference renderer.py:145-182); otherwise the
re-query is a second, separate grid query (:183-188).  ``train.remat_heads``
recomputes the material and light heads in the backward pass instead of
keeping their activations (non-reentrant ``torch.utils.checkpoint``, the
counterpart of the JAX package's ``jax.checkpoint``, renderer.py:112-136).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.models.brdf import masked_dot, specular_brdf_model
from benchmark.reference.models.fields import (
    background_apply,
    base_color_apply,
    environment_light_apply,
    geometric_apply,
    geometric_apply_corners,
    geometric_gather_corners,
    geometric_supports_shared_gather,
    implicit_illumination_apply,
    photogrammetric_apply,
    roughness_apply,
    soft_visibility_apply,
    specular_reflectance_apply,
)
from benchmark.reference.ops.directions import (
    sample_importance_directions,
    sample_uniform_directions,
)
from benchmark.reference.ops.ties import clip
from benchmark.reference.render.sampler import _exclusive_cumprod


def sdf_value_and_spatial_grad(params, x, conf, with_tv=False, tv_sym=True,
                               corners=None):
    """(sdf, feature, gain, d sdf / d x, tv or None) from one forward; the
    spatial gradient keeps its graph so it can be differentiated again.
    ``corners``: the points' octa rows, gathered by the caller."""
    x = x.detach().requires_grad_(True)
    geo = params["geometric-network"]
    with torch.enable_grad():
        if corners is None:
            out = geometric_apply(geo, x, conf, with_tv=with_tv,
                                  tv_sym=tv_sym)
        else:
            out = geometric_apply_corners(geo, x, corners, conf,
                                          with_tv=with_tv, tv_sym=tv_sym)
        sdf = out[0]
        (grad_x,) = torch.autograd.grad(sdf, x, torch.ones_like(sdf),
                                        create_graph=True)
    tv = out[3] if with_tv else None
    return out[0], out[1], out[2], grad_x, tv


def mc_seed(seed: int, step: Optional[int]) -> int:
    """The generator seed of one Monte-Carlo input: ``seed`` itself, or,
    for a fresh draw at ``step`` (``renderer.fixed_graph_seeds: false``),
    ``seed * 2**32 + step``, distinct for every (seed, step) pair with both
    below 2^32.  The JAX package folds the step into its key
    (``jax.random.fold_in``); the draws differ, the law is the same."""
    if step is None:
        return seed
    if not 0 <= step < 2 ** 32:
        raise ValueError(f"step {step} outside [0, 2^32)")
    return seed * 2 ** 32 + step


def make_mc_cdfs(conf, B, R, step: Optional[int] = None,
                 dtype=torch.float32,
                 device="cuda") -> Dict[str, torch.Tensor]:
    """Monte-Carlo uniforms for sampling, one ``torch.Generator`` per seed
    of ``conf.renderer`` (the reference's fixed-seed graph inputs,
    config/default.yaml:117-124).  With ``renderer.fixed_graph_seeds``
    the draw is the same at every step; otherwise ``step`` is folded into
    every seed, the perturbation's normal draw's too (:func:`mc_seed`).
    The draws differ from the JAX reference's; tests hand both sides the
    same numbers."""
    r = conf.renderer
    n_the, n_phi = r.n_thetas, 2 * r.n_thetas
    fresh = None if r.fixed_graph_seeds else step

    def gen(seed):
        g = torch.Generator(device=device)
        g.manual_seed(mc_seed(seed, fresh))
        return g

    def u(seed, shape):
        return torch.rand(shape, generator=gen(seed), dtype=dtype,
                          device=device)

    return dict(
        diffuse_the=u(r.diffuse_cdf_the_seed, (B, R, n_the)),
        diffuse_phi=u(r.diffuse_cdf_phi_seed, (B, R, n_phi)),
        specular_the=u(r.specular_cdf_the_seed, (B, R, n_the)),
        specular_phi=u(r.specular_cdf_phi_seed, (B, R, n_phi)),
        stratified=u(r.stratified_sample_seed, (B, R, r.n_samples0, 1)),
        background=1e-5 + (1 - 1e-5) * u(r.background_sample_seed,
                                         (B, R, r.n_bg_samples + 1, 1)),
        upsample=[u(r.stratified_sample_seed + 1000 + i, (B, R, r.n_samples1))
                  for i in range(r.n_upsamples)],
        perturb=torch.randn(
            (B, R, r.n_samples0 + r.n_samples1 * r.n_upsamples, 3),
            generator=gen(conf.train.base_color_perturb_seed), dtype=dtype,
            device=device),
    )


_HEADS = dict(base_color=base_color_apply, soft_vis=soft_visibility_apply,
              env=environment_light_apply, photo=photogrammetric_apply,
              implicit=implicit_illumination_apply, rough=roughness_apply,
              spec=specular_reflectance_apply, bg=background_apply)


def _heads(conf):
    """The material and light heads by name; with ``train.remat_heads``
    each runs under a non-reentrant checkpoint, which keeps only its
    inputs and recomputes it in the backward pass.  The heads read the
    normal, whose graph the eikonal term differentiates again, so only the
    heads are wrapped: a reentrant checkpoint, or one around the geometric
    network, would cut that double backward."""
    if not conf.train.get("remat_heads", False):
        return _HEADS
    # the heads draw no random numbers, so the RNG state need not be kept
    # (reading it is not allowed while a CUDA graph is captured)
    return {k: partial(checkpoint, f, use_reentrant=False,
                       preserve_rng_state=False)
            for k, f in _HEADS.items()}


def pb_render(params, x_fg, t_fg, x_bg, t_bg, camloc, raydir, mask,
              cos_anneal_ratio, lv_gain, cdfs, conf) -> Dict[str, torch.Tensor]:
    """Render a batch of rays to pixel radiance + auxiliary loss terms
    (reference renderer.py:32-209).  ``cos_anneal_ratio`` and ``lv_gain``
    are the epoch schedules' scalars, floats or 0-dim f32 tensors (no
    branch reads their values), ``cdfs`` from :func:`make_mc_cdfs`."""
    h = _heads(conf)
    B, R, N, _ = x_fg.shape
    raydir_r = raydir.reshape(B, R, 1, 3)
    view_dir = -raydir_r
    eps_normal = conf.renderer.eps_normal

    # geometry + spatial gradient (normal field); the grid TV map rides the
    # same corner gather when the loss needs it
    want_tv = (conf.geometric_network.voxel.type != "none"
               and conf.train.tv_weight > 0.0)
    # base-color smoothness pair: re-query the geometric network at
    # x + noise (reference renderer.py:187-193); on an octa table x_fg and
    # x_ptb share one gather while the spatial gradient runs over the x_fg
    # query alone
    geo = params["geometric-network"]
    Gsz = conf.geometric_network.voxel.grid_size
    r_sphere = conf.renderer.bounding_sphere_radius
    x_ptb = x_fg + cdfs["perturb"] * (math.sqrt(3) * 2 * r_sphere / Gsz)
    if conf.renderer.get("fuse_perturbed_query", True) \
            and geometric_supports_shared_gather(geo, conf):
        corners_fg, corners_ptb = geometric_gather_corners(
            geo, [x_fg, x_ptb], conf)
        _, feature_ptb, _ = geometric_apply_corners(geo, x_ptb, corners_ptb,
                                                    conf)
    else:
        corners_fg = None
        _, feature_ptb, _ = geometric_apply(geo, x_ptb, conf)
    sdf_x_fg, feature_x_fg, gain, grad_x_fg, tv_map = \
        sdf_value_and_spatial_grad(params, x_fg, conf, with_tv=want_tv,
                                   tv_sym=conf.train.tv_sym_backward,
                                   corners=corners_fg)

    # NeuS section-based alpha with annealed iter_cos (renderer.py:55-67);
    # a float ratio is first rounded to f32, so that 1 - car rounds as it
    # does from the 0-dim f32 tensor the trainer passes
    car = cos_anneal_ratio
    if not torch.is_tensor(car):
        car = torch.tensor(float(car), dtype=torch.float32).item()
    true_cos = torch.sum(raydir_r * grad_x_fg, dim=-1, keepdim=True)
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - car)
                 + torch.relu(-true_cos) * car)  # always non-positive
    delta_t_fg = t_fg[:, :, 1:, :] - t_fg[:, :, :-1, :]
    sdf1 = sdf_x_fg + iter_cos * delta_t_fg * 0.5
    sdf0 = sdf_x_fg - iter_cos * delta_t_fg * 0.5
    g = gain.reshape((1,) * sdf_x_fg.ndim)
    cdf0 = torch.sigmoid(g * sdf0)
    cdf1 = torch.sigmoid(g * sdf1)
    alpha_fg = clip((cdf0 - cdf1 + 1e-5) / (cdf0 + 1e-5), 0.0, 1.0)

    # background alpha/color (NeRF++ or constant; renderer.py:70-77)
    if conf.background_modeling:
        delta_bg = (t_bg[:, :, 1:, :] - t_bg[:, :, :-1, :]).detach()
        alpha_bg, color_bg = h["bg"](
            params["background-network"], x_bg, view_dir, delta_bg, conf)
    else:
        alpha_bg = torch.ones((B, R, 1, 1), dtype=x_fg.dtype,
                              device=x_fg.device)
        color_bg = torch.full((B, R, 1, 3), conf.background_color,
                              dtype=x_fg.dtype, device=x_fg.device)

    # joint fg+bg transmittance (renderer.py:79-84)
    alpha = torch.cat([alpha_fg * mask, alpha_bg], dim=2)
    trans = _exclusive_cumprod(1.0 - alpha, dim=2)
    weights = alpha * trans
    trans_fg = trans[:, :, :N, :]
    weights_fg = weights[:, :, :N, :]
    weights_bg = weights[:, :, N:, :]

    def VR(v, w=weights_fg):
        return torch.sum(w * v, dim=2)

    # pixel normal (renderer.py:90-91)
    grad_pixel = VR(grad_x_fg) + eps_normal
    normal_pixel = grad_pixel / torch.linalg.norm(grad_pixel, dim=-1,
                                                  keepdim=True)

    D = feature_x_fg.shape[-1]
    # per-pixel conditioning stays at (B, R, 1, .): the soft-visibility net's
    # split first affine projects it once and broadcasts over the M dirs
    x_pixel = VR(x_fg).reshape(B, R, 1, 3)
    feature_pixel = VR(feature_x_fg).reshape(B, R, 1, D)
    normal_pixel_M = normal_pixel[:, :, None, :]

    # diffuse: uniform hemisphere MC of env * soft-vis * cos (renderer.py:94-119)
    uniform_dirs = sample_uniform_directions(
        normal_pixel, cdfs["diffuse_the"], cdfs["diffuse_phi"]).detach()
    env_int = h["env"](
        params["environment-light-network"], uniform_dirs, conf)
    soft_vis = h["soft_vis"](
        params["soft-visibility-light-network"], x_pixel, uniform_dirs,
        feature_pixel, normal_pixel_M, conf)
    implicit_int = h["implicit"](
        params.get("implicit-illumination-network"), x_fg, feature_x_fg,
        grad_x_fg, conf)
    implicit_pixel = VR(implicit_int)

    cos = masked_dot(normal_pixel_M, uniform_dirs)
    diffuse_env = torch.mean(soft_vis * env_int * cos, dim=2)
    diffuse_light_pixel = diffuse_env + implicit_pixel
    base_color = h["base_color"](
        params["base-color-network"], x_fg, feature_x_fg, grad_x_fg, conf)

    # materials (renderer.py:122-128)
    roughness, std_roughness = h["rough"](
        params["roughness-network"], x_fg, feature_x_fg, grad_x_fg, conf)
    roughness_pixel = VR(roughness)
    specular_reflectance, std_specular = h["spec"](
        params.get("specular-reflectance-network"), x_fg, feature_x_fg,
        grad_x_fg, conf)
    specular_pixel = VR(specular_reflectance)

    # specular MC (renderer.py:131-157)
    if conf.specular_brdf.sampling == "importance":
        spec_dirs = sample_importance_directions(
            normal_pixel, cdfs["specular_the"], cdfs["specular_phi"],
            roughness_pixel).detach()
    else:
        spec_dirs = sample_uniform_directions(
            normal_pixel, cdfs["specular_the"], cdfs["specular_phi"]).detach()
    sBRDF, cos_s = specular_brdf_model(
        normal_pixel, view_dir, spec_dirs, roughness_pixel, specular_pixel,
        conf)
    env_int_s = h["env"](
        params["environment-light-network"], spec_dirs, conf)
    soft_vis_s = h["soft_vis"](
        params["soft-visibility-light-network"], x_pixel, spec_dirs,
        feature_pixel, normal_pixel_M, conf)

    if conf.specular_brdf.use_split_sum:
        specular_color_pixel = torch.mean(soft_vis_s * env_int_s, dim=2) \
            * torch.mean(sBRDF * cos_s, dim=2)
    else:
        specular_color_pixel = torch.mean(
            sBRDF * soft_vis_s * env_int_s * cos_s, dim=2)

    ii = conf.implicit_illumination_network
    if ii.use_me and ii.use_me_on_specular:
        specular_color_pixel = specular_color_pixel + torch.mean(
            sBRDF * implicit_pixel[:, :, :, None], dim=2)

    specular_color_pixel = conf.specular_brdf.weight * specular_color_pixel

    # composition with photogrammetric light (renderer.py:159-176)
    if conf.photogrammetric_light_network.use_me:
        photo_int = h["photo"](
            params["photogrammetric-light-network"], x_fg, camloc, view_dir,
            feature_x_fg, grad_x_fg, lv_gain, conf)
        photo_pixel = VR(photo_int)
        if conf.diffuse_brdf.entangle:
            diffuse_color_pixel = VR(base_color * photo_int)
            color_fg = diffuse_color_pixel * diffuse_light_pixel \
                + photo_pixel * specular_color_pixel
        else:
            diffuse_color_pixel = VR(base_color) * diffuse_light_pixel
            color_fg = photo_pixel * (diffuse_color_pixel
                                      + specular_color_pixel)
    else:
        color_fg = VR(base_color) + specular_color_pixel

    color_pixel = color_fg + VR(color_bg, weights_bg)

    # predicted object mask (renderer.py:183-185)
    if conf.train.mask_weight > 0.0:
        obj_mask_pred = torch.sum(alpha_fg * trans_fg, dim=2)
    else:
        obj_mask_pred = torch.zeros((B, R, 1), dtype=x_fg.dtype,
                                    device=x_fg.device)

    base_color_ptb = h["base_color"](
        params["base-color-network"], x_ptb, feature_ptb, None, conf)

    return dict(
        color_pixel=color_pixel,
        sdf_x_fg=sdf_x_fg,
        grad_x_fg=grad_x_fg,
        alpha_fg=alpha_fg,
        trans_fg=trans_fg,
        obj_mask_pred=obj_mask_pred,
        base_color=base_color,
        base_color_ptb=base_color_ptb,
        roughness=roughness,
        specular_reflectance=specular_reflectance,
        std_roughness=std_roughness,
        std_specular_reflectance=std_specular,
        normal_pixel=normal_pixel,
        gain=gain,
        tv_map=tv_map,
    )
