"""The dual-Adam update of many f32 leaves as two CUDA kernel launches.

``csrc/adam_update.cu`` computes, bitwise, what the PyTorch passes of
:func:`ndjir_torch.train.optim.apply_updates_plain` compute for f32
leaves: pass A (:func:`finite_flag`) tells whether every g + wd·p is
finite, pass B (:func:`update`) updates the moments and the parameters
in place unless that flag is false.  Each pass is one launch for up to
``max_leaves()`` leaves (more are cut into launches of that many), and
neither copies anything from the host, so both capture into a CUDA graph.
Both are counted in ``kernels.LAUNCHES["adam_update"]``.

There is no plain version here: the plain version is the optimizer's own
PyTorch path, which takes every leaf these wrappers refuse (CPU or
non-f32 tensors).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from ndjir_torch import kernels

_KERNEL = "adam_update"


def max_leaves() -> int:
    """Leaves one launch takes."""
    return kernels.load(_KERNEL).adam_update_max_leaves()


def _check(tensors: Sequence[torch.Tensor], numel: int, device) -> None:
    for t in tensors:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"the Adam kernels take CUDA tensors on one "
                             f"device, got {t.device} beside {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the Adam kernels take float32 tensors, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the Adam kernels take contiguous tensors")
        if t.numel() != numel:
            raise ValueError(f"a leaf's tensors differ in size: "
                             f"{t.numel()} and {numel}")


def _addresses(ts: Sequence[torch.Tensor]):
    return (ctypes.c_longlong * len(ts))(*(t.data_ptr() for t in ts))


def _chunks(n: int) -> List[slice]:
    step = max_leaves()
    return [slice(i, i + step) for i in range(0, n, step)]


def finite_flag(gs: Sequence[torch.Tensor], ps: Sequence[torch.Tensor],
                wd: float) -> torch.Tensor:
    """Pass A: a 0-dim bool tensor on the leaves' device, False if some
    element of some ``g + wd * p`` (of ``g`` where ``wd`` is not above 0)
    is not finite.  Leaves are contiguous f32 CUDA tensors, ``gs[i]`` and
    ``ps[i]`` of one size."""
    if not gs or len(gs) != len(ps):
        raise ValueError(f"{len(gs)} gradients for {len(ps)} parameters")
    device = gs[0].device
    for g, p in zip(gs, ps):
        _check((g, p), g.numel(), device)
    flag = torch.ones((), dtype=torch.bool, device=device)
    for part in _chunks(len(gs)):
        g, p = gs[part], ps[part]
        n = (ctypes.c_longlong * len(g))(*(t.numel() for t in g))
        kernels.launch(_KERNEL, "adam_finite_reduce", device, len(g),
                       _addresses(g), _addresses(p), n, wd, int(wd > 0),
                       flag.data_ptr())
        if sum(n) > 0:
            kernels.count(_KERNEL)
    return flag


def update(gs: Sequence[torch.Tensor], ps: Sequence[torch.Tensor],
           ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
           feat: Sequence[bool], finite: torch.Tensor,
           lr_bias_feat: torch.Tensor, lr_bias_weight: torch.Tensor,
           wd: float, b1: float, b2: float, eps: float) -> None:
    """Pass B: unless ``finite`` (a 0-dim bool CUDA tensor) is False, one
    Adam step of every leaf in place: ``g' = g + wd * p`` (``g`` where
    ``wd`` is not above 0), ``m = b1 m + (1 - b1) g'``, ``v = b2 v + (1 -
    b2) g'^2``, ``p -= lr_bias * m / (sqrt(v) + eps)``, with ``lr_bias``
    the 0-dim f32 ``lr_bias_feat`` where ``feat[i]`` and ``lr_bias_weight``
    elsewhere.  The constants are rounded to f32 as PyTorch rounds a
    Python float."""
    if not gs or not (len(gs) == len(ps) == len(ms) == len(vs) == len(feat)):
        raise ValueError("every leaf needs a gradient, a parameter, two "
                         "moments and a learning-rate choice")
    device = gs[0].device
    for g, p, m, v in zip(gs, ps, ms, vs):
        _check((g, p, m, v), g.numel(), device)
    _check((lr_bias_feat, lr_bias_weight), 1, device)
    if finite.dtype != torch.bool or finite.numel() != 1 \
            or finite.device != device:
        raise TypeError(f"a 0-dim bool flag on {device} expected, got "
                        f"{finite.dtype} on {finite.device}")
    for part in _chunks(len(gs)):
        g = gs[part]
        n = (ctypes.c_longlong * len(g))(*(t.numel() for t in g))
        f = (ctypes.c_ubyte * len(g))(*(int(x) for x in feat[part]))
        kernels.launch(_KERNEL, "adam_update_elementwise", device, len(g),
                       _addresses(g), _addresses(ps[part]),
                       _addresses(ms[part]), _addresses(vs[part]), n, f, wd,
                       int(wd > 0), b1, b2, 1 - b1, 1 - b2, eps,
                       finite.data_ptr(), lr_bias_feat.data_ptr(),
                       lr_bias_weight.data_ptr())
        if sum(n) > 0:
            kernels.count(_KERNEL)
