"""The reference put where the program was: the checked epoch of a
training cell and the sampled views of a render cell, computed by the
plain reference from the benchmark's own inputs (the seed's weights, the
scene's arrays, the data layer's draws), never from anything the program
made.  ``tf32`` runs it in the precision below the configuration's (the
control); ``half_batch`` leaves half of every batch out (a fault).

The reference runs f32 matrix products with TF32 off, as the
configurations state (``precision.mlp_dtype: float32``).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from benchmark.reference.config import Config
from benchmark.reference.data.batches import Batches
from benchmark.reference.render.image import render_image
from benchmark.reference.render.renderer import make_mc_cdfs
from benchmark.reference.train import schedules
from benchmark.reference.train.optim import (
    init_optimizer,
    tree_leaves_with_path,
)
from benchmark.reference.train.step import train_step
from benchmark.reference.weights import draw


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def leaf_norms(tree) -> Dict[str, float]:
    names, vals = [], []
    for path, t in tree_leaves_with_path(tree):
        names.append("/".join(path))
        vals.append(torch.linalg.vector_norm(t.float()))
    return dict(zip(names, torch.stack(vals).double().cpu().tolist()))


def epoch_scalars(conf: Config, epoch: int, device):
    """(cos_anneal, lv_gain, lr_weight, lr_feat) of ``epoch`` as 0-dim f32
    tensors: the schedules take effect an epoch late, epoch 0 at lr 0."""
    lr_w, lr_f = schedules.scaled_base_lrs(conf)
    if epoch == 0:
        vals = (0.0, 1.0, 0.0, 0.0)
    else:
        vals = (schedules.cos_anneal_ratio(epoch - 1, conf),
                schedules.light_visibility_gain(epoch - 1, conf),
                schedules.learning_rate(epoch - 1, lr_w, conf),
                schedules.learning_rate(epoch - 1, lr_f, conf))
    return [torch.tensor(v, dtype=torch.float32, device=device)
            for v in vals]


def train_epoch(config: dict, scene, seeds: Dict[str, int], traffic: dict,
                iters: int, device, tf32: bool = False,
                half_batch: bool = False) -> Dict:
    """``iters`` steps from the seed's weights on the scene's batches.
    Returns each step's loss, whether every step was finite, each leaf's
    first-moment norm, each leaf's change norm, and the initial weights
    (``p0``) on ``device``."""
    conf = Config(config)
    images, masks, cameras = scene
    B, R = conf.train.batch_size, conf.train.n_rays
    with matmul_precision(tf32):
        params = draw(config, seeds["weights"], device)
        opt = init_optimizer(params)
        batches = Batches(images, masks, cameras, R,
                          np.random.RandomState(seeds["data"]))
        cdfs = make_mc_cdfs(conf, B, R, device=device)
        keep = B // 2 if half_batch else B
        if half_batch:
            cdfs = {k: ([u[:keep] for u in v] if isinstance(v, list)
                        else v[:keep]) for k, v in cdfs.items()}
        sched = epoch_scalars(conf, int(traffic["start_epoch"]), device)
        losses, finite = [], True
        for _ in range(iters):
            batch = [torch.from_numpy(a[:keep]).to(device)
                     for a in batches.next(B)]
            mons = train_step(params, opt, *batch, *sched, conf, cdfs)
            losses.append(mons["loss"])
            finite = finite and bool(mons["grads_finite"])
        losses = torch.stack(losses).double().cpu().tolist()
        moments = leaf_norms(opt["mu"])
        del opt
        p0 = draw(config, seeds["weights"], device)
        changes = {}
        p0_leaves = dict(tree_leaves_with_path(p0))
        for path, p in tree_leaves_with_path(params):
            changes["/".join(path)] = float(torch.linalg.vector_norm(
                (p - p0_leaves[path]).float()))
        del params
    return {"losses": losses, "finite": finite, "moments": moments,
            "changes": changes, "p0": p0}


def render_view(config: dict, weights_seed: int, pose: np.ndarray,
                intrinsic: np.ndarray, resolution, device,
                chunk: int = 8000, tf32: bool = False):
    """(image (1, 3, H, W), normal (1, H, W, 3), mask (1, H, W, 1)) of one
    view by the reference, ``chunk`` rays at a time (a multiple of
    ``valid.n_rays``: each ray keeps the uniforms of its place in a
    ``valid.n_rays`` chunk)."""
    with matmul_precision(tf32):
        params = draw(config, weights_seed, device)
        out = render_image(params, pose, intrinsic, resolution,
                           Config(config), return_aux=True, chunk=chunk)
        del params
    return out
