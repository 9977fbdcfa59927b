"""Grid-feature scatter-add and the gather whose backward it is.

Counterpart of ``ndjir_tpu/ops/scatter_pallas.py``.  The TPU kernel
(``_scatter_kernel``) becomes ``csrc/scatter_add_rows.cu``: the wrappers
here sort the ids (stable) and hand the kernel the sort's permutation,
through which it reads the values in their own dtype; a pre-pass finds
each slab's range of sorted positions, then the kernel writes every row of
the output, all on the current stream.  On a CPU tensor they
compute the same function with the plain version,
``zeros(num_rows, D).index_add_``; on a CUDA tensor they launch the kernel
or raise.

:class:`GatherRows` is the gather every grid query goes through: forward
``table[ids]``, backward the scatter.  Spatial derivatives never pass
through it (ids are integer), so the eikonal double backward stays ordinary
autograd over the interpolation weights, and its own backward is never
differentiated.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ndjir_torch import kernels

_KERNEL = "scatter_add_rows"
_MAX_D = 1024  # a warp's slab holds at least one row
# (D <= 4, D > 4), where a warp's lanes are updates or columns: output floats
# per slab, which a warp builds in its own shared memory when updates land
# in it (256 rows at D=4, 64 at D=32), and the updates above which a whole
# block sums a slab
_SLAB_FLOATS = (1024, 2048)
_HEAVY = (64, 16)


def _scatter_add_rows_plain(ids: torch.Tensor, vals: torch.Tensor,
                            num_rows: int,
                            acc_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """The plain version: (num_rows, D) dense accumulation in ``acc_dtype``
    (float64 gives the exact sums a kernel is checked against)."""
    out = torch.zeros(num_rows, vals.shape[-1], dtype=acc_dtype,
                      device=vals.device)
    return out.index_add_(0, ids.long(), vals.to(acc_dtype))


def _check(ids: torch.Tensor, vals: torch.Tensor, num_rows: int) -> None:
    if ids.ndim != 1 or vals.ndim != 2 or ids.shape[0] != vals.shape[0]:
        raise ValueError(f"ids (N,) and vals (N, D) expected, got "
                         f"{tuple(ids.shape)} and {tuple(vals.shape)}")
    if ids.device != vals.device:
        raise ValueError(f"ids on {ids.device}, vals on {vals.device}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    if not 0 < num_rows < 2 ** 31:
        raise ValueError(f"num_rows must be in [1, 2^31), got {num_rows}")


def slab_rows(d: int) -> int:
    """Output rows per slab at width ``d``: ``_SLAB_FLOATS`` floats, in
    whole groups of 4 rows (aligned 16-byte stores of a transposed
    column) where a slab holds 4 rows or more."""
    rows = max(1, _SLAB_FLOATS[d > 4] // d)
    return rows - rows % 4 if rows >= 4 else rows


def _lib():
    lib = kernels.load(_KERNEL)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.scatter_slab_starts.argtypes = [p, ll, ll, i, p, p]
    lib.scatter_add_rows.argtypes = [p, p, p, i, p, p, ll, i, ll, i, i, i, p]
    lib.scatter_slab_starts.restype = lib.scatter_add_rows.restype = i
    return lib


def _slab_starts_plain(ids_sorted: torch.Tensor, num_rows: int,
                       rows: int) -> torch.Tensor:
    """The plain version of the kernel's pre-pass: the first sorted
    position of each slab of ``rows`` rows, and the end of the last one
    (ids outside [0, num_rows) lie outside every slab)."""
    n_slabs = -(-num_rows // rows)
    bounds = torch.clamp_max(torch.arange(n_slabs + 1, dtype=torch.int64,
                                          device=ids_sorted.device) * rows,
                             num_rows)
    return torch.searchsorted(ids_sorted.long(), bounds).to(torch.int32)


def _pre_pass(ids_sorted: torch.Tensor, num_rows: int,
              rows: int) -> torch.Tensor:
    """The kernel's scratch, (2 * slabs + 3,) int32, with the slab starts
    in its first slabs + 1 entries: one launch of the pre-pass."""
    if ids_sorted.dtype != torch.int32 or not ids_sorted.is_contiguous():
        raise TypeError("the pre-pass takes contiguous int32 ids")
    n_slabs = -(-num_rows // rows)
    scratch = torch.empty(2 * n_slabs + 3, dtype=torch.int32,
                          device=ids_sorted.device)
    stream = torch.cuda.current_stream(ids_sorted.device).cuda_stream
    err = _lib().scatter_slab_starts(ids_sorted.data_ptr(),
                                     ids_sorted.numel(), num_rows, rows,
                                     scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} pre-pass launch failed: cudaError "
                           f"{err}")
    return scratch


def slab_starts(ids_sorted: torch.Tensor, num_rows: int,
                rows: int) -> torch.Tensor:
    """(ceil(num_rows / rows) + 1,) int32: the first position of ``ids_sorted``
    (int32, ascending) whose id is >= min(s * rows, num_rows), for each s.
    On a CUDA tensor the kernel's pre-pass, one pass over the ids; on a CPU
    tensor the plain version."""
    if not ids_sorted.is_cuda:
        return _slab_starts_plain(ids_sorted, num_rows, rows)
    return _pre_pass(ids_sorted, num_rows, rows)[:-(-num_rows // rows) + 1]


def _launch(ids_sorted: torch.Tensor, perm: torch.Tensor, vals: torch.Tensor,
            num_rows: int, transposed: bool) -> torch.Tensor:
    """The kernel alone (its pre-passes, then the scatter) on ids sorted
    ascending (int32), the sort's permutation (int64) and the values (f32
    or bf16) in input order: a new (num_rows, D) f32 table, or (D,
    num_rows) when ``transposed``, every element written by the kernel."""
    if not (ids_sorted.is_cuda and perm.is_cuda and vals.is_cuda):
        raise ValueError("the scatter kernel takes CUDA tensors")
    if ids_sorted.dtype != torch.int32 or perm.dtype != torch.int64 \
            or vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int32 ids, an int64 permutation and float32 or "
                        f"bfloat16 values expected, got {ids_sorted.dtype}, "
                        f"{perm.dtype} and {vals.dtype}")
    if not (ids_sorted.is_contiguous() and perm.is_contiguous()
            and vals.is_contiguous()):
        raise ValueError("the scatter kernel takes contiguous tensors")
    n, d = vals.shape
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"the scatter kernel takes 1 <= D <= {_MAX_D}, "
                         f"got {d}")
    rows = slab_rows(d)
    scratch = _pre_pass(ids_sorted, num_rows, rows)
    shape = (d, num_rows) if transposed else (num_rows, d)
    out = torch.empty(shape, dtype=torch.float32, device=vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    with torch.cuda.device(vals.device):
        err = _lib().scatter_add_rows(
            ids_sorted.data_ptr(), perm.data_ptr(), vals.data_ptr(),
            int(vals.dtype == torch.bfloat16), scratch.data_ptr(),
            out.data_ptr(), n, d, num_rows, rows, int(transposed),
            _HEAVY[d > 4], stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: cudaError {err}")
    return out


def sort_updates(ids: torch.Tensor):
    """(ids sorted ascending as int32, the sort's int64 permutation); the
    sort is stable, so equal ids keep their input order.  Only the keys
    are sorted: the kernel reads the values through the permutation."""
    return torch.sort(ids.to(torch.int32), stable=True)


def _scatter_add_rows_cuda(ids: torch.Tensor, vals: torch.Tensor,
                           num_rows: int, transposed: bool) -> torch.Tensor:
    """Sort, then one launch of the kernel (counted in ``LAUNCHES``)."""
    if vals.dtype not in (torch.float32, torch.bfloat16):
        vals = vals.float()
    out = _launch(*sort_updates(ids), vals.contiguous(), num_rows,
                  transposed)
    kernels.LAUNCHES[_KERNEL] += 1
    return out


def scatter_add_rows(ids: torch.Tensor, vals: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """sum_i onehot(ids[i]) * vals[i] -> (num_rows, D), accumulated in f32
    and returned in the values' dtype.  ids (N,) int, vals (N, D)."""
    _check(ids, vals, num_rows)
    if vals.device.type == "cpu":
        out = _scatter_add_rows_plain(ids, vals, num_rows)
    elif vals.device.type == "cuda":
        out = _scatter_add_rows_cuda(ids, vals, num_rows, transposed=False)
    else:
        raise ValueError(f"no scatter for device {vals.device}")
    return out.to(vals.dtype)


def scatter_add_rows_t(ids: torch.Tensor, vals: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """Transposed scatter-add: (D, num_rows) f32 accumulation."""
    _check(ids, vals, num_rows)
    if vals.device.type == "cpu":
        return _scatter_add_rows_plain(ids, vals, num_rows).t().contiguous()
    if vals.device.type == "cuda":
        return _scatter_add_rows_cuda(ids, vals, num_rows, transposed=True)
    raise ValueError(f"no scatter for device {vals.device}")


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
