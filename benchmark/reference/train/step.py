"""One training step of the reference, written out in plain PyTorch: a
frozen copy of ``loss_and_grads`` and ``train_step`` of
``ndjir_torch/train/trainer.py`` on one device (no sharding): sample ->
render -> the nine loss terms -> gradients with the eikonal double
backward -> dual Adam with its non-finite skip.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from benchmark.reference.render.loss import total_loss
from benchmark.reference.train.optim import (
    apply_updates,
    tree_leaves_with_path,
)


def loss_and_grads(params, camloc, raydir, color_gt, obj_mask, cos_anneal,
                   lv_gain, conf, cdfs):
    """(loss, detached monitors, grads shaped like ``params``; zeros for
    a leaf the loss does not reach)."""
    leaves = list(tree_leaves_with_path(params))
    for _, p in leaves:
        p.requires_grad_(True)
    try:
        loss, monitors = total_loss(params, camloc, raydir, color_gt,
                                    obj_mask, cos_anneal, lv_gain, conf,
                                    cdfs=cdfs)
        gs = torch.autograd.grad(loss, [p for _, p in leaves],
                                 allow_unused=True)
    finally:
        for _, p in leaves:
            p.requires_grad_(False)
    grads: Dict[str, Any] = {}
    for (path, p), g in zip(leaves, gs):
        node = grads
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.zeros_like(p) if g is None else g
    monitors = {k: v.detach() for k, v in monitors.items()}
    return loss.detach(), monitors, grads


def train_step(params, opt_state, camloc, raydir, color_gt, obj_mask,
               cos_anneal, lv_gain, lr_weight, lr_feat, conf, cdfs
               ) -> Dict[str, torch.Tensor]:
    """One step, updating ``params`` and ``opt_state`` in place; returns
    the loss monitors plus ``grads_finite``."""
    _, monitors, grads = loss_and_grads(
        params, camloc, raydir, color_gt, obj_mask, cos_anneal, lv_gain,
        conf, cdfs)
    monitors["grads_finite"] = apply_updates(
        params, grads, opt_state, lr_weight, lr_feat, conf)
    return monitors
