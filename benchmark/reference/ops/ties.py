"""|x| and clamps whose gradients at a tie are the JAX package's.

``jnp.abs``'s cotangent is ``select(x >= 0, g, -g)``: +g at +-0 and -g at
NaN, where ``torch.abs``'s is 0 at all three.  ``jnp.maximum`` and
``jnp.minimum`` send half the cotangent to each operand that equals the
result (``jax.lax`` ``_balanced_eq``), and ``jnp.clip(x, lo, hi)`` is
``minimum(maximum(lo, x), hi)``: at x == lo or x == hi its gradient is 1/2,
where ``torch.clamp``'s is 1.  The values are the torch ops' own, bitwise.
"""

from __future__ import annotations

from typing import Optional

import torch


def absolute(x: torch.Tensor) -> torch.Tensor:
    """|x|, with the gradient ``select(x >= 0, g, -g)`` (the value's zeros
    keep the sign of x's)."""
    return torch.where(x >= 0, x, -x)


def _max_weight(x: torch.Tensor, bound: float) -> torch.Tensor:
    """d maximum(bound, x) / dx as ``jax.lax`` takes it: 1 above the bound,
    1/2 at it, 0 below it and at NaN."""
    return torch.where(x > bound, 1.0, torch.where(x == bound, 0.5, 0.0))


def _min_weight(x: torch.Tensor, bound: float) -> torch.Tensor:
    return torch.where(x < bound, 1.0, torch.where(x == bound, 0.5, 0.0))


class _Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, lo: Optional[float],
                hi: Optional[float]) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.lo, ctx.hi
        w = None
        if lo is not None:
            w = _max_weight(x, lo)
            x = torch.clamp_min(x, lo)
        if hi is not None:
            w = _min_weight(x, hi) if w is None else w * _min_weight(x, hi)
        return g * w.to(g.dtype), None, None


def clip(x: torch.Tensor, lo: Optional[float],
         hi: Optional[float] = None) -> torch.Tensor:
    """``torch.clamp(x, lo, hi)`` (either bound None for none) with
    ``jnp.clip``'s gradient: g inside, g/2 at a bound, 0 outside and at
    NaN (times g, so a non-finite g stays non-finite, as in JAX)."""
    return _Clip.apply(x, lo, hi)
