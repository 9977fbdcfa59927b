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

The skip is decided on the device, as in the JAX package: the finite flag
is never read on the host, so a step queues without waiting on the card and
can be captured in a CUDA graph.  The step count is a device int32 scalar
and the bias correction is computed from it in f32.  Parameters and
moments are updated in place, a leaf's update holding one f32 scratch
beside its gradient (a bf16 leaf also its f32 gradient): at G=512 each
table-sized f32 temporary is 2.1 GB.  A skip selects instead of
branching: the gradient is masked to -0.0 and the moments' decay to 1,
and the step to +0.0, so every value stays bitwise what it was.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch
import torch.distributed

from benchmark.reference.models.fields import is_grid_feature_path

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
    """{"count": steps taken (a 0-dim int32 tensor on the parameters'
    device), "mu": f32 first moments, "nu": f32 second}."""
    def f32_zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(p for _, p in tree_leaves_with_path(params)).device
    return {"count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": tree_map(f32_zeros, params),
            "nu": tree_map(f32_zeros, params)}


def bias_correction(count: torch.Tensor) -> torch.Tensor:
    """sqrt(1 - b2^t) / (1 - b1^t) at t = count + 1, in f32 (reference
    ndjir_tpu/train/optim.py:90-91)."""
    tf = (count + 1).to(torch.float32)
    return torch.sqrt(1.0 - torch.pow(_B2, tf)) / (1.0 - torch.pow(_B1, tf))


@torch.no_grad()
def apply_updates(params, grads, state, lr_weight, lr_feat, conf,
                  group=None) -> torch.Tensor:
    """One optimizer step, in place on ``params`` and ``state``.  ``grads``
    mirrors ``params`` and is consumed (overwritten); ``lr_weight`` and
    ``lr_feat`` are floats or 0-dim f32 tensors.  Returns whether the
    gradients were finite, as a 0-dim bool tensor on the device, never
    read here: a non-finite step leaves the parameters, both moments and
    the count bitwise unchanged.  With a process ``group`` (a sharded
    step, its gradients already summed) the flag is the AND over the
    group's ranks, so all of them skip a step together."""
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
        flag = finite.to(torch.int32)
        torch.distributed.all_reduce(flag, torch.distributed.ReduceOp.MIN,
                                     group=group)
        finite = flag.bool()

    count = state["count"]
    bias = bias_correction(count)
    # a skipped step multiplies the moments by 1 and adds -0.0 (the masked
    # gradient), which leaves every value as it was, -0.0 included
    skip = ~finite
    keep_m = torch.where(finite, _B1, 1.0)
    keep_v = torch.where(finite, _B2, 1.0)
    mu = dict(tree_leaves_with_path(state["mu"]))
    nu = dict(tree_leaves_with_path(state["nu"]))
    for g, (path, p) in zip(gs, leaves):
        m, v = mu[path], nu[path]
        g32 = g.float()     # the gradient itself when it is f32
        g32.masked_fill_(skip, -0.0)
        m.mul_(keep_m).add_(g32, alpha=1 - _B1)
        v.mul_(keep_v).addcmul_(g32, g32, value=1 - _B2)
        del g32
        lr = lr_feat if is_grid_feature_path(path) else lr_weight
        step = torch.sqrt(v)
        step.add_(_EPS)
        torch.div(m, step, out=step)
        step.mul_(lr * bias)
        step.masked_fill_(skip, 0.0)    # p - (+0.0) is p
        if p.dtype == torch.float32:
            p.sub_(step)
        else:   # one rounding of p - step, as p + (-step)
            p.copy_(step.neg_().add_(p))
        del step
    count.add_(finite.to(count.dtype))
    return finite
