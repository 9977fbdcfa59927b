"""Full-image neural rendering (validation, the render entry point).

Counterpart of ``ndjir_tpu/render/image.py`` (reference renderer.py:212-272):
one chunk of ``valid.n_rays`` pixels at a time, sample_points + pb_render at
cos_anneal=1, over every pixel of a downsampled view.  Each chunk is
computed without a graph (the normal's spatial gradient enables grad on
the points alone).  On a table in the octa layout the octa table is built
once per call (one B3 launch) and every chunk reads it.
"""

from __future__ import annotations

import numpy as np
import torch

from ndjir_torch.config import Config
from ndjir_torch.data.cameras import (
    generate_all_pixels,
    generate_raydir_camloc,
)
from ndjir_torch.models.fields import with_octa_table
from ndjir_torch.render.renderer import make_mc_cdfs, pb_render
from ndjir_torch.render.sampler import sample_points
from ndjir_torch.train.optim import tree_leaves_with_path
from ndjir_torch.train.schedules import light_visibility_gain


def params_device(params) -> torch.device:
    """The device the parameter tree lives on (its first leaf's)."""
    return next(tree_leaves_with_path(params))[1].device


def chunk_conf(conf) -> Config:
    """``conf`` with the perturbed base-color query unfused: rendering never
    reads its result (reference image.py:40, ``_canonical_chunk_conf``)."""
    data = conf.to_dict()
    data["renderer"]["fuse_perturbed_query"] = False
    return Config(data)


def render_image(params, pose, intrinsic, resolution, conf,
                 return_aux: bool = False, lv_gain: float | None = None):
    """Render one view on the device ``params`` live on.  pose (1, 4, 4);
    intrinsic (1, 3, 3); resolution (W, H) at full size.

    ``lv_gain`` is the photogrammetric-light sigmoid gain; it defaults to
    the end of the training schedule (what a fully-trained model was
    optimized for); validation passes the current epoch's value.  The view
    is rendered at 1 / 2^valid.n_down_samples of ``resolution``.  Returns
    the NCHW float image clipped to [0, 1] (reference renderer.py:267-268),
    optionally plus the (1, H, W, 3) normal and (1, H, W, 1) mask maps.
    """
    if lv_gain is None:
        lv_gain = light_visibility_gain(conf.train.epoch, conf)
    dev = params_device(params)
    scale = 1.0 / 2 ** conf.valid.n_down_samples
    W, H = resolution
    W, H = int(W * scale), int(H * scale)
    P = conf.valid.n_rays

    intrinsic = intrinsic.copy()
    intrinsic[:, :2, :] *= scale  # fx, fy, cx, cy, skew

    # pad the pixel list to a whole number of P-ray chunks (the reference
    # shrinks P by the remainder instead, renderer.py:237-241)
    P = min(P, W * H)
    xy = generate_all_pixels(W, H).reshape(1, H * W, 2)
    n_pad = (-(W * H)) % P
    if n_pad:
        xy = np.concatenate([xy, np.tile(xy[:, -1:, :], (1, n_pad, 1))],
                            axis=1)
    total = xy.shape[1]

    cconf = chunk_conf(conf)
    # fixed graph seeds: every chunk draws the same uniforms
    cdfs = make_mc_cdfs(cconf, 1, P, device=dev)
    params = with_octa_table(params, cconf)
    colors, normals, masks = [], [], []
    with torch.no_grad():
        for p in range(0, total, P):
            raydir, camloc = generate_raydir_camloc(pose, intrinsic,
                                                    xy[:, p:p + P, :])
            camloc = torch.from_numpy(camloc).to(dev)
            raydir = torch.from_numpy(raydir).to(dev)
            x_fg, t_fg, x_bg, t_bg, mask = sample_points(
                params, camloc, raydir, cdfs["stratified"],
                cdfs["background"], cconf, rand_u=cdfs["upsample"])
            res = pb_render(params, x_fg, t_fg, x_bg, t_bg, camloc, raydir,
                            mask, 1.0, lv_gain, cdfs, cconf)
            colors.append(res["color_pixel"].detach()[0])
            normals.append(res["normal_pixel"].detach()[0])
            masks.append(res["obj_mask_pred"].detach().reshape(-1, 1))
    del params  # the octa table, if one was built

    def gather(parts, c):
        a = torch.cat(parts).cpu().numpy().astype(np.float32)
        return a[:H * W].reshape(1, H, W, c)
    rimage = np.clip(gather(colors, 3).transpose(0, 3, 1, 2), 0, 1)
    if return_aux:
        return rimage, gather(normals, 3), gather(masks, 1)
    return rimage
