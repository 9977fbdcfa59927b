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
and the bias correction is computed from it in f32.

Two paths compute the same numbers, bitwise.  On the card, with gradient
clipping off (every preset), the f32 leaves go through two CUDA kernels
(:mod:`ndjir_torch.ops.adam_update`): one launch checks every such leaf's
g + wd·p, one updates their moments and parameters in place, and neither
writes a gradient or holds a scratch tensor.  Every other leaf (CPU
leaves, a bf16 grid table) and every leaf under clipping takes the plain
PyTorch passes (:func:`apply_updates_plain`), which overwrite the
gradient and hold one f32 scratch beside it (a bf16 leaf also its f32
gradient).  There a skip selects instead of branching: the gradient is
masked to -0.0 and the moments' decay to 1, and the step to +0.0, so
every value stays bitwise what it was; the kernel writes nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch
import torch.distributed

from ndjir_torch.models.fields import is_grid_feature_path
from ndjir_torch.ops import adam_update
from ndjir_torch.utils.profiling import annotate

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


def _fused(p: torch.Tensor) -> bool:
    """Whether the kernels take this leaf (when clipping is off)."""
    return p.is_cuda and p.dtype == torch.float32


def _decay(gs, ps, wd) -> None:
    """L2 weight decay folded into the gradients (nnabla semantics)."""
    if wd > 0:
        for g, p in zip(gs, ps):
            g.add_(p.to(g.dtype), alpha=wd)


def _all_finite(flags, gs, group) -> torch.Tensor:
    """The AND of ``flags`` (0-dim bools) and every gradient's finiteness,
    then over the process ``group``'s ranks."""
    parts = list(flags) + [torch.isfinite(g).all() for g in gs]
    finite = parts[0] if len(parts) == 1 else torch.stack(parts).all()
    if group is not None:
        flag = finite.to(torch.int32)
        torch.distributed.all_reduce(flag, torch.distributed.ReduceOp.MIN,
                                     group=group)
        finite = flag.bool()
    return finite


def _update_plain(leaves, gs, mu, nu, finite, bias, lr_weight,
                  lr_feat) -> None:
    """The moments and parameters of ``leaves`` by PyTorch passes, in
    place; ``gs`` (decayed, clipped) are overwritten."""
    # a skipped step multiplies the moments by 1 and adds -0.0 (the masked
    # gradient), which leaves every value as it was, -0.0 included
    skip = ~finite
    keep_m = torch.where(finite, _B1, 1.0)
    keep_v = torch.where(finite, _B2, 1.0)
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


@torch.no_grad()
def apply_updates_plain(params, grads, state, lr_weight, lr_feat, conf,
                        group=None) -> torch.Tensor:
    """:func:`apply_updates` by PyTorch passes alone, on any device: the
    plain version of the kernels, which every CPU leaf, non-f32 leaf and
    clipped step takes.  ``grads`` is consumed (overwritten)."""
    leaves = list(tree_leaves_with_path(params))
    g_leaves = dict(tree_leaves_with_path(grads))
    gs = [g_leaves[path] for path, _ in leaves]
    _decay(gs, [p for _, p in leaves], conf.train.weight_decay)

    if conf.train.clip_grad_norm > 0:
        clip = conf.train.clip_grad_norm
        gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in gs))
        scale = torch.clamp_max(clip / torch.clamp_min(gn, 1e-12), 1.0)
        # a bf16 gradient times the f32 scale is f32, as in the reference
        gs = [g.mul_(scale) if g.dtype == torch.float32 else g.float() * scale
              for g in gs]

    finite = _all_finite((), gs, group)
    count = state["count"]
    _update_plain(leaves, gs, dict(tree_leaves_with_path(state["mu"])),
                  dict(tree_leaves_with_path(state["nu"])), finite,
                  bias_correction(count), lr_weight, lr_feat)
    count.add_(finite.to(count.dtype))
    return finite


@torch.no_grad()
def apply_updates(params, grads, state, lr_weight, lr_feat, conf,
                  group=None) -> torch.Tensor:
    """One optimizer step, in place on ``params`` and ``state``.  ``grads``
    mirrors ``params``; the leaves of the plain path overwrite theirs, the
    kernels' leaves leave theirs as they were.  ``lr_weight`` and
    ``lr_feat`` are floats or 0-dim f32 tensors.  Returns whether the
    gradients were finite, as a 0-dim bool tensor on the device, never
    read here: a non-finite step leaves the parameters, both moments and
    the count bitwise unchanged.  With a process ``group`` (a sharded
    step, its gradients already summed) the flag is the AND over the
    group's ranks, so all of them skip a step together.

    With clipping off, the f32 leaves on a CUDA device go through the two
    kernels of :mod:`ndjir_torch.ops.adam_update` (under the span
    ``optim.fused``, with their count and elements), the rest through
    :func:`apply_updates_plain`'s passes."""
    leaves = list(tree_leaves_with_path(params))
    if conf.train.clip_grad_norm > 0 \
            or not any(_fused(p) for _, p in leaves):
        return apply_updates_plain(params, grads, state, lr_weight, lr_feat,
                                   conf, group=group)
    wd = conf.train.weight_decay
    g_leaves = dict(tree_leaves_with_path(grads))
    mu = dict(tree_leaves_with_path(state["mu"]))
    nu = dict(tree_leaves_with_path(state["nu"]))
    fused = [(path, p) for path, p in leaves if _fused(p)]
    rest = [(path, p) for path, p in leaves if not _fused(p)]
    rest_gs = [g_leaves[path] for path, _ in rest]
    count = state["count"]
    bias = bias_correction(count)
    with annotate("optim.fused", leaves=len(fused),
                  elems=sum(p.numel() for _, p in fused)):
        gs = [g_leaves[path] for path, _ in fused]
        ps = [p for _, p in fused]
        flag = adam_update.finite_flag(gs, ps, wd)
        _decay(rest_gs, [p for _, p in rest], wd)
        finite = _all_finite((flag,), rest_gs, group)
        adam_update.update(
            gs, ps, [mu[path] for path, _ in fused],
            [nu[path] for path, _ in fused],
            [is_grid_feature_path(path) for path, _ in fused], finite,
            lr_feat * bias, lr_weight * bias, wd, _B1, _B2, _EPS)
    if rest:
        _update_plain(rest, rest_gs, mu, nu, finite, bias, lr_weight,
                      lr_feat)
    count.add_(finite.to(count.dtype))
    return finite
