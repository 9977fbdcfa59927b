"""Octa table build, the (Gx, Gy, Gz, D) base table as (Gx*Gy*Gz, 8D)
rows, in plain PyTorch: a frozen copy of the plain form of
``ndjir_torch/ops/octa_build.py`` for the benchmark's reference.
"""

from __future__ import annotations

import torch

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


def build_octa_table(base: torch.Tensor) -> torch.Tensor:
    """(Gx, Gy, Gz, D) base table -> (Gx*Gy*Gz, 8D) octa table in the base
    table's dtype, from a table that does not require grad."""
    if base.requires_grad:
        raise ValueError("the octa table is built only from a frozen base "
                         "table")
    return _build_octa_table_plain(base)
