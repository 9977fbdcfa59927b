"""The Lanczos-2 dense-grid query as one CUDA kernel, for queries that build
no autograd graph.

``csrc/lanczos_voxel_gather.cu`` computes what the composite
:func:`ndjir_torch.ops.grid.query_voxel_lanczos` computes at ``a = 2`` (64
taps a point), bitwise, in one launch instead of about 650 PyTorch
launches.  It has no backward: :func:`query_voxel_lanczos` takes it only
where no graph is built (grad mode off, or neither the points nor the table
requiring grad) on CUDA tensors, and the composite everywhere else.

The composite's last step sums the (64, N, D) products over dim 0; the
kernel adds the 64 taps of each output in the order PyTorch's CUDA
reduction takes where N*D is a multiple of 4 and at least 128, and takes
only those calls (:func:`sums_in_warps`).  The proposal sampler's,
``render_image``'s and an extraction's queries are all far larger.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ndjir_torch import kernels

_KERNEL = "lanczos_voxel_gather"


def sums_in_warps(outputs: int) -> bool:
    """Whether PyTorch's CUDA ``sum(dim=0)`` adds the 64 taps of each of
    ``outputs`` = N*D outputs, laid out on the fastest axis, in the kernel's
    order: four outputs a thread and the taps split over four warps, which
    it does where ``outputs`` is a multiple of 4 and at least 128."""
    return outputs % 4 == 0 and outputs >= 128


def lanczos_voxel_gather(x: torch.Tensor, table: torch.Tensor,
                         vmin: Sequence[float], vmax: Sequence[float]
                         ) -> torch.Tensor:
    """Points (..., 3) and a (Gx, Gy, Gz, D) table, both f32 on one CUDA
    device, the table contiguous, N*D a multiple of 4 and at least 128
    (:func:`sums_in_warps`) -> (..., D) f32: the Lanczos-2 query over the
    box (vmin, vmax) in one launch, counted in ``kernels.LAUNCHES``.
    Carries no gradient."""
    if not (x.is_cuda and table.is_cuda) or x.device != table.device:
        raise ValueError(f"the Lanczos gather takes CUDA tensors on one "
                         f"device, got {x.device} and {table.device}")
    if x.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"the Lanczos gather takes f32 points and table, got "
                        f"{x.dtype} and {table.dtype}")
    if table.dim() != 4 or not table.is_contiguous() or x.shape[-1] != 3:
        raise ValueError(f"points (..., 3) and a contiguous (Gx, Gy, Gz, D) "
                         f"table expected, got {tuple(x.shape)} and "
                         f"{tuple(table.shape)}")
    Gx, Gy, Gz, D = (int(s) for s in table.shape)
    pts = x.reshape(-1, 3).contiguous()
    n = pts.shape[0]
    if not sums_in_warps(n * D):
        raise ValueError(f"the Lanczos gather sums in the composite's order "
                         f"only for N*D a multiple of 4 and at least 128, "
                         f"got N={n}, D={D}")
    out = torch.empty((n, D), dtype=torch.float32, device=x.device)
    lo = (ctypes.c_float * 3)(*vmin)
    hi = (ctypes.c_float * 3)(*vmax)
    kernels.launch(_KERNEL, _KERNEL, x.device, pts.data_ptr(),
                   table.data_ptr(), out.data_ptr(), n, Gx, Gy, Gz, D, lo, hi)
    kernels.count(_KERNEL)
    return out.reshape(*x.shape[:-1], D)
