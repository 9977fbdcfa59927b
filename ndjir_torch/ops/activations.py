"""Activation functions (counterpart of ``ndjir_tpu/ops/activations.py``).

Element-wise ops; every one is twice-differentiable, as the eikonal
double backward needs.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ndjir_torch import kernels

# above beta x = 20 softplus returns x, as PyTorch's fused op does
_THRESHOLD = 20.0

# The first derivative on the card: one elementwise kernel, compiled at
# first use by PyTorch's jiterator (which keeps it in its kernel cache on
# disk), instantiated for float32, bfloat16 and float16, with
# softplus_backward's own arithmetic
# (float opmath; z / (z + 1) with z = exp(beta x), g above the threshold)
# and 0 at x = +-0, which the plain version takes a second pass over the
# tensor to write.  BETA and THRESHOLD are float32 hex literals.
_GRAD_CODE = """
template <typename T> T NAME(T g, T x) {
  const float beta = BETA, threshold = THRESHOLD;
  float xf = static_cast<float>(x);
  if (xf == 0.0f) {
    return static_cast<T>(0.0f);
  }
  float bx = xf * beta;
  float z = expf(bx);
  return bx > threshold ? g
                        : static_cast<T>(static_cast<float>(g) * z / (z + 1.0f));
}
"""
_GRAD_FNS: Dict[float, Callable] = {}
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _f32_literal(v: float) -> str:
    return float(np.float32(v)).hex() + "f"


def _softplus_grad_kernel(beta: float) -> Callable:
    fn = _GRAD_FNS.get(beta)
    if fn is None:
        from torch.cuda import jiterator

        name = f"ndjir_softplus_grad_{len(_GRAD_FNS)}"
        code = _GRAD_CODE.replace("NAME", name) \
            .replace("BETA", _f32_literal(beta)) \
            .replace("THRESHOLD", _f32_literal(_THRESHOLD))
        fn = _GRAD_FNS[beta] = jiterator._create_jit_fn(code)
    return fn


def _softplus_grad_plain(g: torch.Tensor, x: torch.Tensor,
                         beta: float) -> torch.Tensor:
    d = torch.ops.aten.softplus_backward(g, x, beta, _THRESHOLD)
    return d.masked_fill_(x == 0, 0.0)


def _softplus_grad(g: torch.Tensor, x: torch.Tensor,
                   beta: float) -> torch.Tensor:
    """g * softplus_beta'(x) as PyTorch's fused backward computes it
    (z / (z + 1) with z = exp(beta x); 1 above the threshold), and 0 at
    x = +-0, where the reference's max(x, 0) + log1p(exp(-beta |x|)) / beta
    takes half of g from the max's tie and minus half from |x|.  One
    jiterator kernel on CUDA tensors of float32, bfloat16 or float16 (any
    other dtype, or g and x of two dtypes, raises); on CPU tensors the
    plain version (:func:`_softplus_grad_plain`)."""
    if not x.is_cuda:
        return _softplus_grad_plain(g, x, beta)
    if x.dtype not in _KERNEL_DTYPES or g.dtype != x.dtype:
        raise TypeError(f"softplus gradient on the card: no kernel for "
                        f"g {g.dtype} and x {x.dtype} (it takes one of "
                        f"{_KERNEL_DTYPES} for both)")
    return _softplus_grad_kernel(beta)(g, x)


def _softplus_grad_grad_plain(gg: torch.Tensor, g: torch.Tensor,
                              x: torch.Tensor, beta: float,
                              need_dg: bool = True, need_dx: bool = True):
    """(dg, dx), the derivatives of g * softplus_beta'(x) in g and in x
    under the cotangent gg, each None where not needed: dg is
    :func:`_softplus_grad` of gg; dx is gg g beta sigmoid(beta x) (1 -
    sigmoid(beta x)) below the threshold and 0 above it, as PyTorch's ops
    compute it one after another (each rounding to the dtype)."""
    dg = _softplus_grad(gg, x, beta) if need_dg else None
    dx = None
    if need_dx:
        bx = x * beta
        dx = torch.ops.aten.sigmoid_backward(gg * g, bx.sigmoid()) \
            * (bx < _THRESHOLD).to(gg.dtype) * beta
    return dg, dx


# the second derivative's kernel (csrc/softplus_grad_grad.cu): its dtypes
_GRAD_GRAD = "softplus_grad_grad"
_GRAD_GRAD_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """The distance between t's rows (along its last axis) where each row
    is contiguous and the rows lie at one stride: a contiguous tensor, or
    a slice of one along the last axis (the cotangent that the skip
    concatenation hands the layer before it).  None for any other
    layout."""
    cols = t.shape[-1] if t.dim() else 1
    if t.is_contiguous():
        return cols
    if t.stride(-1) != 1:
        return None
    try:
        ld = t.view(-1, cols).stride(0)
    except RuntimeError:
        return None
    return ld if ld >= cols else None


def _kernel_operands(gg: torch.Tensor, g: Optional[torch.Tensor],
                     x: torch.Tensor):
    """(gg, g, x, g's row stride) as the second derivative's kernel reads
    them (g None where dx is not wanted): gg and x contiguous, g
    contiguous or rows at one stride (:func:`_row_stride`), each copied
    only where it is not.  All of one shape and of one of the kernel's
    dtypes; anything else raises, as the first derivative does."""
    ts = (gg, x) if g is None else (gg, g, x)
    if x.dtype not in _GRAD_GRAD_DTYPES \
            or any(t.dtype != x.dtype or t.shape != x.shape for t in ts):
        raise TypeError(
            f"softplus second derivative on the card: no kernel for "
            f"{[(t.dtype, tuple(t.shape)) for t in ts]} (it takes one shape "
            f"and one of {tuple(_GRAD_GRAD_DTYPES)} for all)")
    cols = x.shape[-1] if x.dim() else 1
    ld = cols
    if g is not None:
        ld = _row_stride(g)
        if ld is None:
            g, ld = g.contiguous(), cols
    return gg.contiguous(), g, x.contiguous(), ld


def _softplus_grad_grad(gg: torch.Tensor, g: torch.Tensor, x: torch.Tensor,
                        beta: float, need_dg: bool, need_dx: bool):
    """:func:`_softplus_grad_grad_plain`'s (dg, dx), bitwise.  On the card
    one launch of the hand-written kernel (counted in
    ``kernels.LAUNCHES``), f32 or bf16 (:func:`_kernel_operands`); CPU
    tensors take the plain form."""
    if not x.is_cuda:
        return _softplus_grad_grad_plain(gg, g, x, beta, need_dg, need_dx)
    gg, g, x, ld = _kernel_operands(gg, g if need_dx else None, x)
    dg = torch.empty_like(x) if need_dg else None
    dx = torch.empty_like(x) if need_dx else None
    cols = x.shape[-1] if x.dim() else 1
    kernels.launch(_GRAD_GRAD, _GRAD_GRAD, x.device,
                   _GRAD_GRAD_DTYPES[x.dtype], gg.data_ptr(),
                   g.data_ptr() if need_dx else None, x.data_ptr(),
                   dg.data_ptr() if need_dg else None,
                   dx.data_ptr() if need_dx else None, x.numel(), cols, ld,
                   beta, _THRESHOLD)
    kernels.count(_GRAD_GRAD)
    return dg, dx


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
    too (beta / 4, as the reference's).  Both in one pass on the card
    (:func:`_softplus_grad_grad`)."""

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
        dg, dx = _softplus_grad_grad(gg, g, x, ctx.beta,
                                     *ctx.needs_input_grad[:2])
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
