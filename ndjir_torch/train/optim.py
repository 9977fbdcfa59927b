"""Dual Adam with the reference's feature/weight split, written out by hand
(counterpart of ``ndjir_tpu/train/optim.py``; reference python/solver.py).

Grid-feature leaves (:func:`is_grid_feature_path`) take ``lr_feat``,
everything else ``lr_weight``.  The rule is nnabla Adam's, which
``torch.optim.Adam`` is not:

    g += wd * w                               (L2 added to the gradient)
    g *= min(1, clip / ||g||)                 (clip_grad_norm > 0; true grad)
    m = b1 m + (1-b1) g;  v = b2 v + (1-b2) g^2
    w -= lr * sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps)

with eps outside the *uncorrected* sqrt(v), moments always float32, and a
non-finite gradient skipping params, moments and the step count alike
(reference: train.py:141-146).  The update is computed in f32 and rounded
once into the parameter's dtype, so a bf16 grid table (G=256: 134 MB) keeps
f32 moments and takes one rounding per step (reference optim.py:93-98).
Parameters and moments are updated in place: at G=512 each table-sized f32
temporary is 2.1 GB.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import torch
import torch.distributed

from ndjir_torch.models.fields import is_grid_feature_path

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def tree_leaves_with_path(tree, path=()) -> Iterator[Tuple[tuple, Any]]:
    """(key path, leaf) pairs of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_leaves_with_path(v, path + (k,))
        else:
            yield path + (k,), v


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def init_optimizer(params) -> Dict[str, Any]:
    """{"count": steps taken, "mu": f32 first moments, "nu": f32 second}."""
    def f32_zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"count": 0, "mu": tree_map(f32_zeros, params),
            "nu": tree_map(f32_zeros, params)}


@torch.no_grad()
def apply_updates(params, grads, state, lr_weight: float, lr_feat: float,
                  conf, group=None) -> bool:
    """One optimizer step, in place on ``params`` and ``state``.  ``grads``
    mirrors ``params`` and is consumed (overwritten).  Returns whether the
    gradients were finite (the step was taken).  With a process ``group``
    (a sharded step, its gradients already summed) the flag is the AND over
    the group's ranks, so all of them skip a step together."""
    wd = conf.train.weight_decay
    leaves = list(tree_leaves_with_path(params))
    g_leaves = dict(tree_leaves_with_path(grads))
    gs = [g_leaves[path] for path, _ in leaves]

    if wd > 0:  # L2 weight decay folded into the gradient (nnabla semantics)
        for g, (_, p) in zip(gs, leaves):
            g.add_(p.to(g.dtype), alpha=wd)

    if conf.train.clip_grad_norm > 0:
        clip = conf.train.clip_grad_norm
        gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in gs))
        scale = torch.clamp_max(clip / torch.clamp_min(gn, 1e-12), 1.0)
        # a bf16 gradient times the f32 scale is f32, as in the reference
        gs = [g.mul_(scale) if g.dtype == torch.float32 else g.float() * scale
              for g in gs]

    finite = torch.stack([torch.isfinite(g).all() for g in gs]).all()
    if group is not None:
        finite = finite.to(torch.int32)
        torch.distributed.all_reduce(finite, torch.distributed.ReduceOp.MIN,
                                     group=group)
    if not bool(finite):
        return False

    t = state["count"] + 1
    bias = math.sqrt(1.0 - _B2 ** t) / (1.0 - _B1 ** t)
    mu = dict(tree_leaves_with_path(state["mu"]))
    nu = dict(tree_leaves_with_path(state["nu"]))
    for g, (path, p) in zip(gs, leaves):
        m, v = mu[path], nu[path]
        g32 = g.float()
        m.mul_(_B1).add_(g32, alpha=1 - _B1)
        v.mul_(_B2).add_(g32 * g32, alpha=1 - _B2)
        lr = lr_feat if is_grid_feature_path(path) else lr_weight
        step = (m / v.sqrt().add_(_EPS)).mul_(lr * bias)
        if p.dtype == torch.float32:
            p.sub_(step)
        else:
            p.copy_(p.float() - step)
    state["count"] = t
    return True
