"""Activation functions: a frozen copy of ``ndjir_torch/ops/activations.py``
for the benchmark's reference, its first derivative of softplus in the
plain two-pass form on every device.

Element-wise ops; every one is twice-differentiable, as the eikonal
double backward needs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

# above beta x = 20 softplus returns x, as PyTorch's fused op does
_THRESHOLD = 20.0


def _softplus_grad_plain(g: torch.Tensor, x: torch.Tensor,
                         beta: float) -> torch.Tensor:
    d = torch.ops.aten.softplus_backward(g, x, beta, _THRESHOLD)
    return d.masked_fill_(x == 0, 0.0)


def _softplus_grad(g: torch.Tensor, x: torch.Tensor,
                   beta: float) -> torch.Tensor:
    """g * softplus_beta'(x) as PyTorch's fused backward computes it, and 0
    at x = +-0: the plain two-pass form on every device."""
    return _softplus_grad_plain(g, x, beta)


class _Softplus(torch.autograd.Function):
    """softplus_beta(x), saving only x; its derivative is
    :class:`_SoftplusGrad`."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, beta: float) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.beta = beta
        return F.softplus(x, beta=beta, threshold=_THRESHOLD)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        return _SoftplusGrad.apply(g, x, ctx.beta), None


class _SoftplusGrad(torch.autograd.Function):
    """g * softplus_beta'(x) (:func:`_softplus_grad`), differentiable once
    more for the eikonal double backward: in g, the same first derivative;
    in x, beta sigmoid(beta x) (1 - sigmoid(beta x)) below the threshold
    and 0 above it, PyTorch's own second derivative of softplus, at x = 0
    too (beta / 4, as the reference's)."""

    @staticmethod
    def forward(ctx, g: torch.Tensor, x: torch.Tensor,
                beta: float) -> torch.Tensor:
        ctx.save_for_backward(g, x)
        ctx.beta = beta
        return _softplus_grad(g, x, beta)

    @staticmethod
    @once_differentiable
    def backward(ctx, gg: torch.Tensor):
        g, x = ctx.saved_tensors
        beta = ctx.beta
        dg = _softplus_grad(gg, x, beta) if ctx.needs_input_grad[0] \
            else None
        dx = None
        if ctx.needs_input_grad[1]:
            bx = x * beta
            dx = torch.ops.aten.sigmoid_backward(gg * g, bx.sigmoid()) \
                * (bx < _THRESHOLD).to(gg.dtype) * beta
        return dg, dx, None


def softplus(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """softplus_beta(x) = log(1 + exp(beta x)) / beta.  The networks use
    beta=100 (reference: python/network.py:165).

    PyTorch's fused op saves only its input for the (double) backward, where
    the reference's stable form max(x, 0) + log1p(exp(-beta |x|)) / beta
    would save three tensors per hidden layer.  The two agree to f32
    rounding in value; above beta x = 20 the fused op returns x, which
    differs from the stable form by < 2e-9 / beta.  The first derivative is
    the fused op's but at x = 0, where the reference's is 0 (the fused
    op's is 1/2); the second derivative is the fused op's, beta / 4 at 0 as
    the reference's (:class:`_SoftplusGrad`)."""
    return _Softplus.apply(x, beta)


def squareplus(x: torch.Tensor, b: float = 4.0) -> torch.Tensor:
    """squareplus(x) = (x + sqrt(x^2 + b)) / 2 — a cheap smooth relu."""
    return 0.5 * (x + torch.sqrt(x * x + b))


def get_activation(name: str, beta: float = 100.0):
    """Hidden-layer activation dispatch (reference: python/network.py:164-166)."""
    if name == "relu":
        return torch.relu
    if name == "softplus":
        return lambda x: softplus(x, beta=beta)
    if name == "squareplus":
        return squareplus
    raise ValueError(f"Unknown activation: {name}")


def get_last_activation(name: str, inverse_black_degree: float = 1.0):
    """Output-head activation dispatch (reference: python/network.py:289-292)."""
    if name == "softplus":
        return lambda x: softplus(x, beta=inverse_black_degree)
    if name == "relu":
        return torch.relu
    if name == "sigmoid":
        return torch.sigmoid
    raise ValueError(f"Unknown last activation: {name}")
