"""Grid-feature scatter-add and the gather whose backward it is, in plain
PyTorch: a frozen copy of the plain forms of ``ndjir_torch/ops/scatter.py``
for the benchmark's reference.  The scatter is a dense ``index_add_`` in
f32 that drops ids outside the table; no kernel is built or launched.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable


def _scatter_add_rows_plain(ids: torch.Tensor, vals: torch.Tensor,
                            num_rows: int,
                            acc_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """(num_rows, D) dense accumulation in ``acc_dtype``; ids outside
    [0, num_rows) are dropped."""
    out = torch.zeros(num_rows, vals.shape[-1], dtype=acc_dtype,
                      device=vals.device)
    inside = (ids >= 0) & (ids < num_rows)
    if not bool(inside.all()):
        ids, vals = ids[inside], vals[inside]
    return out.index_add_(0, ids.long(), vals.to(acc_dtype))


def scatter_add_rows(ids: torch.Tensor, vals: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """sum_i onehot(ids[i]) * vals[i] -> (num_rows, D), accumulated in f32
    and returned in the values' dtype."""
    return _scatter_add_rows_plain(ids, vals, num_rows).to(vals.dtype)


def scatter_add_rows_t(ids: torch.Tensor, vals: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """Transposed scatter-add: (D, num_rows) f32 accumulation."""
    return _scatter_add_rows_plain(ids, vals, num_rows).t().contiguous()


class GatherRows(torch.autograd.Function):
    """table (M, D), ids (...,) int -> (..., D); d table = scatter-add."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return table.index_select(0, ids.reshape(-1)).reshape(
            *ids.shape, table.shape[-1])

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        (ids,) = ctx.saved_tensors
        dtable = scatter_add_rows(ids.reshape(-1),
                                  g.reshape(-1, g.shape[-1]), ctx.num_rows)
        return dtable, None


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return GatherRows.apply(table, ids)
