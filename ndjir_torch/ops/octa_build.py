"""Octa table build: the (Gx, Gy, Gz, D) base table as (Gx*Gy*Gz, 8D) rows.

Counterpart of ``_voxel_octa_flat`` in ``ndjir_tpu/ops/grid.py`` and of its
Pallas form (``scripts/probe_build_variants.py:_pallas_octa_kernel``),
which becomes ``csrc/build_octa_table.cu``.  Row (x, y, z) holds in channel
block c = dx*4 + dy*2 + dz the features of cell (x+dx, y+dy, z+dz), each +1
neighbour clamped to the last slice of its axis: a pure copy, so the kernel
and the plain version agree bitwise.

Inference (``render_image``, ``extract``) builds the table once per call
from a frozen base table and gathers one 8D row per point
(:func:`ndjir_torch.ops.grid.query_voxel`).  Training never builds it: its
base table changes every step, and its forward gathers the 8 corners
straight from the base table (``GatherRowsOcta``).

On a CPU tensor :func:`build_octa_table` computes the plain version; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ndjir_torch import kernels

_KERNEL = "build_octa_table"


def _build_octa_table_plain(base: torch.Tensor) -> torch.Tensor:
    """The plain version, line for line ``_voxel_octa_flat``: three ``dup``
    steps of slice-and-cat, on z, then y, then x."""
    def dup(f, axis):
        L = f.shape[axis]
        shifted = torch.cat([f.narrow(axis, 1, L - 1),
                             f.narrow(axis, L - 1, 1)], dim=axis)
        return torch.cat([f, shifted], dim=-1)

    f = dup(base, 2)             # (..., 2D): (z0, z1)
    f = dup(f, 1)                # (..., 4D): (y0z0, y0z1, y1z0, y1z1)
    f = dup(f, 0)                # (..., 8D): x0 block then x1 block
    return f.reshape(-1, 8 * base.shape[-1])


def _launch(base: torch.Tensor) -> torch.Tensor:
    """The kernel alone: a new (Gx*Gy*Gz, 8D) table, every element written
    by the kernel."""
    if not base.is_cuda:
        raise ValueError("the octa build kernel takes CUDA tensors")
    if base.dim() != 4 or not base.is_contiguous():
        raise ValueError(f"a contiguous (Gx, Gy, Gz, D) table expected, got "
                         f"{tuple(base.shape)}")
    Gx, Gy, Gz, D = (int(n) for n in base.shape)
    out = torch.empty((Gx * Gy * Gz, 8 * D), dtype=base.dtype,
                      device=base.device)
    kernels.launch(_KERNEL, _KERNEL, base.device, base.data_ptr(),
                   out.data_ptr(), Gx, Gy, Gz, D, base.element_size())
    return out


def build_octa_table(base: torch.Tensor) -> torch.Tensor:
    """(Gx, Gy, Gz, D) base table -> (Gx*Gy*Gz, 8D) octa table in the base
    table's dtype.  The result carries no gradient: it is built only from a
    table that does not require one."""
    if base.dim() != 4 or min(base.shape) < 1:
        raise ValueError(f"a (Gx, Gy, Gz, D) table expected, got "
                         f"{tuple(base.shape)}")
    if base.requires_grad:
        raise ValueError("the octa table is built only from a frozen base "
                         "table; training gathers from the base table")
    if base.device.type == "cpu":
        return _build_octa_table_plain(base)
    if base.device.type == "cuda":
        out = _launch(base)
        kernels.count(_KERNEL)
        return out
    raise ValueError(f"no octa build for device {base.device}")
