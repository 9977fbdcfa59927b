"""Total training loss (counterpart of ``ndjir_tpu/render/loss.py``;
reference python/loss.py:27-192).

Sample points -> pb_render -> nine weighted terms (RGB, eikonal, TV, mask
BCE, base-color smoothness prior, roughness / specular aleatoric priors and
their log-std regularizers); every term is returned for monitoring.

Every term is a sum over rays (and their samples) divided by a count over
the whole batch: ``sum(obj_mask)``, ``sum(mask)`` (times N), or B*R.  A
ray-sharded step (:mod:`ndjir_torch.parallel.mesh`) hands
``reduce_counts``, which sums those counts across the shards before the
division; each shard's loss is then its share of the batch's loss, and the
sum of the shards' gradients is the batch's gradient.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from benchmark.reference.ops.ties import absolute, clip
from benchmark.reference.render.renderer import make_mc_cdfs, pb_render
from benchmark.reference.render.sampler import sample_points


def total_loss(params, camloc, raydir, color_gt, obj_mask, cos_anneal_ratio,
               lv_gain, conf, cdfs: Optional[Dict[str, torch.Tensor]] = None,
               step: Optional[int] = None,
               proposal_grid: Optional[torch.Tensor] = None,
               reduce_counts: Optional[Callable[[torch.Tensor],
                                                torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (scalar loss, dict of per-term monitors).

    camloc (B, 3); raydir (B, R, 3); color_gt (B, R, 3); obj_mask (B, R, 1).
    ``cdfs`` are the Monte-Carlo uniforms (``make_mc_cdfs(..., step)``
    when None); ``proposal_grid`` the coarse-grid snapshot.
    ``reduce_counts`` maps the stacked counts ``[sum(obj_mask), sum(mask),
    B*R]`` to their sums over all shards of the batch.
    """
    B, R, _ = color_gt.shape
    tr = conf.train

    if cdfs is None:
        cdfs = make_mc_cdfs(conf, B, R, step=step, dtype=color_gt.dtype,
                            device=color_gt.device)
    x_fg, t_fg, x_bg, t_bg, mask = sample_points(
        params, camloc, raydir, cdfs["stratified"], cdfs["background"], conf,
        rand_u=cdfs["upsample"], proposal_grid=proposal_grid)
    res = pb_render(params, x_fg, t_fg, x_bg, t_bg, camloc, raydir, mask,
                    cos_anneal_ratio, lv_gain, cdfs, conf)

    N = x_fg.shape[2]
    zero = torch.zeros((), dtype=color_gt.dtype, device=color_gt.device)
    n_obj, n_mask, n_rays = torch.sum(obj_mask), torch.sum(mask), B * R
    if reduce_counts is not None:
        n_obj, n_mask, n_rays = reduce_counts(torch.stack([
            n_obj, n_mask.to(n_obj.dtype),
            torch.full((), float(n_rays), dtype=n_obj.dtype,
                       device=n_obj.device)])).unbind()

    # RGB (loss.py:59-66)
    err = absolute(res["color_pixel"] - color_gt) if tr.rgb_loss == "l1" \
        else (res["color_pixel"] - color_gt) ** 2
    if tr.mask_weight > 0.0:
        loss_rgb = torch.sum(err * obj_mask) / (n_obj + 1e-5)
    else:
        loss_rgb = torch.sum(err) / n_rays

    denorm = n_mask * N + 1e-5

    # eikonal (loss.py:69-76)
    if tr.eikonal_weight > 0.0:
        gn = torch.linalg.norm(res["grad_x_fg"], dim=-1, keepdim=True)
        loss_eikonal = torch.sum(((gn - 1.0) * mask) ** 2) / denorm
    else:
        loss_eikonal = zero

    # TV over grid features (loss.py:79-105), from the main grid query
    if conf.geometric_network.voxel.type != "none" and tr.tv_weight > 0.0:
        loss_tv = torch.sum(res["tv_map"] * mask) / denorm
    else:
        loss_tv = zero

    # mask BCE (loss.py:107-115)
    if tr.mask_weight > 0.0:
        p = clip(res["obj_mask_pred"], 1e-3, 1.0 - 1e-3)
        bce = -(obj_mask * torch.log(p) + (1.0 - obj_mask) * torch.log(1.0 - p))
        loss_mask = torch.sum(bce) / (n_mask + 1e-5)
    else:
        loss_mask = zero

    # base-color smoothness prior (loss.py:121-129)
    if tr.base_color_prior_weight > 0.0:
        bc = res["base_color"]
        if not tr.base_color_prior_sym_backward:
            bc = bc.detach()
        prior_base_color = torch.sum(
            absolute(bc - res["base_color_ptb"]) * mask) / denorm
    else:
        prior_base_color = zero

    # roughness aleatoric prior + log-std reg (loss.py:132-147)
    if tr.roughness_prior_weight > 0.0:
        pv = conf.roughness_network.prior_value
        prior_roughness = torch.sum(
            absolute(res["roughness"] - pv) / res["std_roughness"] * mask
        ) / denorm
        reg_std_roughness = torch.sum(
            clip(torch.log(res["std_roughness"]), 1e-5, 1e5) * mask
        ) / denorm
    else:
        prior_roughness = reg_std_roughness = zero

    # specular reflectance prior + reg (loss.py:149-165)
    if tr.specular_reflectance_prior_weight > 0.0:
        pv = conf.specular_reflectance_network.prior_value
        prior_specular = torch.sum(
            absolute(res["specular_reflectance"] - pv)
            / res["std_specular_reflectance"] * mask) / denorm
        reg_std_specular = torch.sum(
            clip(torch.log(res["std_specular_reflectance"]), 1e-5, 1e5)
            * mask) / denorm
    else:
        prior_specular = reg_std_specular = zero

    loss = (loss_rgb
            + tr.eikonal_weight * loss_eikonal
            + tr.tv_weight * loss_tv
            + tr.mask_weight * loss_mask
            + tr.base_color_prior_weight * prior_base_color
            + tr.roughness_prior_weight * prior_roughness
            + tr.specular_reflectance_prior_weight * prior_specular
            + tr.roughness_prior_weight * reg_std_roughness
            + tr.specular_reflectance_prior_weight * reg_std_specular)

    monitors = dict(
        loss=loss,
        loss_rgb=loss_rgb,
        loss_eikonal=loss_eikonal,
        loss_tv=loss_tv,
        loss_mask=loss_mask,
        prior_base_color=prior_base_color,
        prior_roughness=prior_roughness,
        prior_specular_reflectance=prior_specular,
        reg_std_roughness=reg_std_roughness,
        reg_std_specular_reflectance=reg_std_specular,
        gain=res["gain"][0],
    )
    return loss, monitors
