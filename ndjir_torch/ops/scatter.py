"""Grid-feature scatter-add and the gather whose backward it is.

Counterpart of ``ndjir_tpu/ops/scatter_pallas.py``.  The TPU kernel
(``_scatter_kernel``) becomes ``csrc/scatter_add_rows.cu``: the wrappers
here sort the ids with its stable radix sort (ids outside the table become
a sentinel key) and hand the kernel the sort's permutation, through which
it reads the values in their own dtype; its pre-passes find each slab's
range of sorted positions and cut the heavy slabs into pieces, then it
writes every row of the output, all on the current stream.  On a CPU
tensor they compute the same function with the plain version,
``zeros(num_rows, D).index_add_``; on a CUDA tensor they launch the kernel
or raise.

:class:`GatherRows` is the gather every grid query goes through: forward
``table[ids]``, backward the scatter.  Spatial derivatives never pass
through it (ids are integer), so the eikonal double backward stays ordinary
autograd over the interpolation weights, and its own backward is never
differentiated.  Its forward (:func:`take_rows`) on a CUDA table is one
launch of ``csrc/gather_rows.cu``, a byte copy with the bits of
``index_select``, whose 16-byte rows PyTorch gives a 32-thread block each;
on a CPU table it is ``index_select``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from ndjir_torch import kernels

_KERNEL = "scatter_add_rows"
_MAX_D = 1024  # a warp's slab holds at least one row
# Per width class (D <= 4 and D <= 8, where a warp's lanes are updates; D >
# 8, where they are columns): the output floats of a slab, which a warp
# builds in its own shared memory (256 rows at D=4, 128 at D=8, 64 at
# D=32), and the piece: a slab with more updates is cut into pieces of this
# many sorted updates, each built by a warp of its own.  Chosen by
# scripts/torch_scatter_sweep.py at every shape a training step gives the
# kernel (PERF.md).
_SLAB_FLOATS = (1024, 1024, 2048)
_PIECE = (1024, 512, 64)
# The bucket path, where a small table takes many updates a row (the voxel
# hash: 35 and 70 a row, where it is measured): the fewest updates a row
# that take it, the largest bucket (2^11 rows: 32 KB of one warp's shared
# memory at D=4) and the updates a warp takes at once (chosen by
# scripts/torch_scatter_sweep.py at the hash's shapes)
_BUCKET_MIN_PER_ROW = 8
_BUCKET_MAX_BITS = 11
_BUCKET_PIECE = 8192


def _width_class(d: int) -> int:
    return 0 if d <= 4 else 1 if d <= 8 else 2


def _scatter_add_rows_plain(ids: torch.Tensor, vals: torch.Tensor,
                            num_rows: int,
                            acc_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """The plain version: (num_rows, D) dense accumulation in ``acc_dtype``
    (float64 gives the exact sums a kernel is checked against); ids
    outside [0, num_rows) are dropped, as the kernel drops them."""
    out = torch.zeros(num_rows, vals.shape[-1], dtype=acc_dtype,
                      device=vals.device)
    inside = (ids >= 0) & (ids < num_rows)
    if not bool(inside.all()):
        ids, vals = ids[inside], vals[inside]
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
    """Output rows per slab at width ``d``: its class's ``_SLAB_FLOATS``
    floats, in whole groups of 4 rows (aligned 16-byte stores of a
    transposed column) where a slab holds 4 rows or more."""
    rows = max(1, _SLAB_FLOATS[_width_class(d)] // d)
    return rows - rows % 4 if rows >= 4 else rows


def piece_size(d: int) -> int:
    """Sorted updates per piece of a slab cut into pieces, at width ``d``."""
    return _PIECE[_width_class(d)]


def _max_pieces(n: int, piece: int, n_slabs: int = 0,
                cut: int | None = None) -> int:
    # every slab with more than `cut` updates is cut, each with at most one
    # short piece: with cut = piece there are fewer such slabs than
    # n / piece
    if cut is None or cut >= piece:
        return 2 * -(-n // piece) + 1
    return -(-n // piece) + n_slabs + 1


def _pieces_offset(n_slabs: int) -> int:
    return (2 * n_slabs + 4) & ~1


def bucket_bits(n: int, vals: torch.Tensor, num_rows: int) -> int:
    """log2 of the rows of a bucket where the bucket path takes the scatter
    (the sort orders the keys by bucket only, in one radix pass, carrying
    the 16-byte f32 rows at D=4, and the kernel sums each bucket in shared
    memory): at D=4 f32 into at most 2^19 rows, with at least
    ``_BUCKET_MIN_PER_ROW`` updates a row; else 0, the sorted path."""
    bits = num_rows.bit_length() - 8
    if vals.dtype != torch.float32 or vals.shape[1] != 4 \
            or not 0 < bits <= _BUCKET_MAX_BITS \
            or n < _BUCKET_MIN_PER_ROW * num_rows:
        return 0
    return bits


def sort_keys_plain(ids: torch.Tensor, num_rows: int,
                    bits: int = 0) -> torch.Tensor:
    """The keys the sort orders, as int32: each id inside [0, num_rows),
    else a sentinel that lies in no slab or bucket: num_rows, or with
    buckets of 2^bits rows the first row of the bucket past the table."""
    inside = (ids >= 0) & (ids < num_rows)
    sentinel = -(-num_rows >> bits) << bits
    return torch.where(inside, ids.long(), sentinel).to(torch.int32)


def _sort_updates_plain(ids: torch.Tensor, num_rows: int):
    keys, perm = torch.sort(sort_keys_plain(ids, num_rows), stable=True)
    return keys, perm.to(torch.int32)


def _sort_launch(ids: torch.Tensor, num_rows: int, bits: int = 0,
                 vals: torch.Tensor | None = None):
    """The kernel's sort: the key map, then a stable radix sort, over every
    key bit carrying an int32 permutation, or (bits > 0) by bucket only
    carrying ``vals``' 16-byte rows."""
    ids = ids.contiguous()
    n = ids.numel()
    size = ctypes.c_size_t(0)
    kernels.call(_KERNEL, "scatter_sort_bytes", n, num_rows, bits,
                 ctypes.byref(size))
    temp_bytes = size.value
    keys = torch.empty(2, n, dtype=torch.int32, device=ids.device)
    if bits:
        values_in = vals.contiguous()
        if values_in.data_ptr() % 16:   # the sort reads 16-byte rows
            values_in = values_in.clone()
        values_out = torch.empty_like(values_in)
    else:
        values_in = torch.empty(2, n, dtype=torch.int32, device=ids.device)
        values_out = values_in[1]
    temp = torch.empty(max(1, temp_bytes), dtype=torch.uint8,
                       device=ids.device)
    kernels.launch(_KERNEL, "scatter_sort", ids.device, ids.data_ptr(),
                   int(ids.dtype == torch.int64), n, num_rows, bits,
                   keys.data_ptr(), values_in.data_ptr(),
                   values_out.data_ptr(), temp.data_ptr(), temp_bytes)
    return keys[1], values_out


def sort_updates(ids: torch.Tensor, num_rows: int):
    """(the keys sorted ascending, the sort's permutation), both int32: ids
    outside [0, num_rows) become the key num_rows, which lies in no slab.
    The sort is stable, so equal keys keep their input order, and only the
    keys are sorted: the kernel reads the values through the permutation.
    On a CUDA tensor the kernel's radix sort over bit_length(num_rows)
    bits; on a CPU tensor the plain version (``torch.sort``)."""
    if not ids.is_cuda:
        return _sort_updates_plain(ids, num_rows)
    return _sort_launch(ids, num_rows)


def _sort_by_bucket_plain(ids: torch.Tensor, vals: torch.Tensor,
                          num_rows: int, bits: int):
    keys = sort_keys_plain(ids, num_rows, bits)
    order = torch.sort(keys >> bits, stable=True)[1]
    return keys[order], vals[order]


def sort_by_bucket(ids: torch.Tensor, vals: torch.Tensor, num_rows: int,
                   bits: int):
    """The bucket path's sort: (the keys, ``vals``' rows in their order),
    ordered stably by bucket (key >> bits) only, so a bucket's updates keep
    their input order.  On a CUDA tensor the kernel's radix sort carrying
    the 16-byte rows; on a CPU tensor the plain version."""
    if not ids.is_cuda:
        return _sort_by_bucket_plain(ids, vals, num_rows, bits)
    if vals.dtype != torch.float32 or vals.shape[1] != 4:
        raise ValueError("the bucket path carries f32 rows of 4")
    return _sort_launch(ids, num_rows, bits, vals)


def _slab_starts_plain(ids_sorted: torch.Tensor, num_rows: int,
                       rows: int, bits: int = 0) -> torch.Tensor:
    """The plain version of the kernel's pre-pass: the first sorted
    position of each slab of ``rows`` rows, and the end of the last one
    (ids outside [0, num_rows) lie outside every slab).  With ``bits``,
    the keys are sorted by bucket (key >> bits, 2^bits = rows) only."""
    n_slabs = -(-num_rows // rows)
    bounds = torch.clamp_max(torch.arange(n_slabs + 1, dtype=torch.int64,
                                          device=ids_sorted.device) * rows,
                             num_rows)
    if bits:
        return torch.searchsorted(ids_sorted.long() >> bits,
                                  -(-bounds >> bits)).to(torch.int32)
    return torch.searchsorted(ids_sorted.long(), bounds).to(torch.int32)


def _piece_plan_plain(starts: torch.Tensor, piece: int,
                      cut_above: int | None = None) -> torch.Tensor:
    """The plain version of the kernel's plan: (P, 2) int32 rows (slab,
    index in the slab), one for each piece of ``piece`` sorted updates of
    every slab with more than ``cut_above`` (default ``piece``) updates,
    in slab order."""
    counts = (starts[1:] - starts[:-1]).long()
    cut = torch.nonzero(counts > (piece if cut_above is None
                                  else cut_above)).flatten()
    n = -(-counts[cut] // piece)
    slab = torch.repeat_interleave(cut, n)
    first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    k = torch.arange(slab.numel(), device=starts.device) - first
    return torch.stack([slab, k], 1).to(torch.int32)


def _plan_launch(ids_sorted: torch.Tensor, num_rows: int, rows: int,
                 piece: int, cut_above: int | None = None) -> torch.Tensor:
    """The kernel's scratch (int32): the slab starts in its first
    ceil(num_rows / rows) + 1 entries, then the piece count, each cut
    slab's first piece and the piece list; one launch each of the two
    pre-passes."""
    if ids_sorted.dtype != torch.int32 or not ids_sorted.is_contiguous():
        raise TypeError("the pre-pass takes contiguous int32 ids")
    n_slabs = -(-num_rows // rows)
    n = ids_sorted.numel()
    cut = piece if cut_above is None else cut_above
    scratch = torch.empty(_pieces_offset(n_slabs)
                          + 2 * _max_pieces(n, piece, n_slabs, cut),
                          dtype=torch.int32, device=ids_sorted.device)
    kernels.launch(_KERNEL, "scatter_plan", ids_sorted.device,
                   ids_sorted.data_ptr(), n, num_rows, rows, piece, cut,
                   scratch.data_ptr())
    return scratch


def slab_starts(ids_sorted: torch.Tensor, num_rows: int, rows: int,
                bits: int = 0) -> torch.Tensor:
    """(ceil(num_rows / rows) + 1,) int32: the first position of ``ids_sorted``
    (int32, ascending, or by bucket key >> bits) whose id is >= min(s *
    rows, num_rows), for each s.  On a CUDA tensor the kernel's pre-pass
    (one pass over the ids, or a binary search per slab where the slabs
    are few); on a CPU tensor the plain version."""
    if not ids_sorted.is_cuda:
        return _slab_starts_plain(ids_sorted, num_rows, rows, bits)
    return _plan_launch(ids_sorted, num_rows, rows,
                        2 ** 30)[:-(-num_rows // rows) + 1]


def piece_plan(ids_sorted: torch.Tensor, num_rows: int, rows: int,
               piece: int, cut_above: int | None = None,
               bits: int = 0) -> torch.Tensor:
    """(P, 2) int32 (slab, index in the slab): the pieces of every slab of
    ``rows`` rows that takes more than ``cut_above`` (default ``piece``)
    of the sorted ids, in slab order.  On a CUDA tensor the kernel's plan
    (whose list, in no particular order, comes back sorted); on a CPU
    tensor the plain version."""
    if not ids_sorted.is_cuda:
        return _piece_plan_plain(
            _slab_starts_plain(ids_sorted, num_rows, rows, bits), piece,
            cut_above)
    n_slabs = -(-num_rows // rows)
    scratch = _plan_launch(ids_sorted, num_rows, rows, piece, cut_above)
    count = int(scratch[n_slabs + 1].item())
    at = _pieces_offset(n_slabs)
    pieces = scratch[at:at + 2 * count].view(count, 2).long()
    order = torch.argsort(pieces[:, 0] * (2 ** 31) + pieces[:, 1])
    return pieces[order].to(torch.int32)


def _launch(ids_sorted: torch.Tensor, perm: torch.Tensor, vals: torch.Tensor,
            num_rows: int, transposed: bool) -> torch.Tensor:
    """The kernel alone (its pre-passes, the scatter and the fix-up) on
    keys sorted ascending (int32), the sort's permutation (int32) and the
    values (f32 or bf16) in input order: a new (num_rows, D) f32 table, or
    (D, num_rows) when ``transposed``, every element written by the
    kernel."""
    if not (ids_sorted.is_cuda and perm.is_cuda and vals.is_cuda):
        raise ValueError("the scatter kernel takes CUDA tensors")
    if ids_sorted.dtype != torch.int32 or perm.dtype != torch.int32 \
            or vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int32 keys, an int32 permutation and float32 or "
                        f"bfloat16 values expected, got {ids_sorted.dtype}, "
                        f"{perm.dtype} and {vals.dtype}")
    if not (ids_sorted.is_contiguous() and perm.is_contiguous()
            and vals.is_contiguous()):
        raise ValueError("the scatter kernel takes contiguous tensors")
    n, d = vals.shape
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"the scatter kernel takes 1 <= D <= {_MAX_D}, "
                         f"got {d}")
    rows, piece = slab_rows(d), piece_size(d)
    scratch = _plan_launch(ids_sorted, num_rows, rows, piece)
    partials = torch.empty(2 * _max_pieces(n, piece) * d, dtype=torch.float32,
                           device=vals.device)
    shape = (d, num_rows) if transposed else (num_rows, d)
    out = torch.empty(shape, dtype=torch.float32, device=vals.device)
    kernels.launch(_KERNEL, "scatter_add_rows", vals.device,
                   ids_sorted.data_ptr(), perm.data_ptr(), vals.data_ptr(),
                   int(vals.dtype == torch.bfloat16), scratch.data_ptr(),
                   partials.data_ptr(), out.data_ptr(), n, d, num_rows, rows,
                   int(transposed), piece)
    return out


def _launch_buckets(keys: torch.Tensor, vals: torch.Tensor, num_rows: int,
                    bits: int) -> torch.Tensor:
    """The bucket path's kernel alone (its pre-passes, the bucket sums and
    their combine) on keys sorted by bucket (key >> bits) and the f32 rows
    of 4 in their order: a new (num_rows, 4) f32 table, every element
    written by the kernel."""
    if not (keys.is_cuda and vals.is_cuda):
        raise ValueError("the scatter kernel takes CUDA tensors")
    if keys.dtype != torch.int32 or vals.dtype != torch.float32 \
            or vals.shape[1] != 4:
        raise TypeError("int32 keys and (N, 4) float32 rows expected")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("the scatter kernel takes contiguous tensors")
    n = keys.numel()
    rows = 1 << bits
    scratch = _plan_launch(keys, num_rows, rows, _BUCKET_PIECE, 0)
    lines = -(-n // _BUCKET_PIECE) + -(-num_rows // rows)
    partials = torch.empty(lines * rows * 4, dtype=torch.float32,
                           device=vals.device)
    out = torch.empty(num_rows, 4, dtype=torch.float32, device=vals.device)
    kernels.launch(_KERNEL, "scatter_add_rows_buckets", vals.device,
                   keys.data_ptr(), vals.data_ptr(), scratch.data_ptr(),
                   partials.data_ptr(), out.data_ptr(), n, num_rows, bits,
                   _BUCKET_PIECE)
    return out


def _scatter_add_rows_cuda(ids: torch.Tensor, vals: torch.Tensor,
                           num_rows: int, transposed: bool) -> torch.Tensor:
    """Sort, then one launch of the kernel (counted in ``LAUNCHES``): the
    bucket path where :func:`bucket_bits` takes it, else the sorted
    path."""
    if vals.dtype not in (torch.float32, torch.bfloat16):
        vals = vals.float()
    bits = 0 if transposed else bucket_bits(ids.numel(), vals, num_rows)
    if bits:
        out = _launch_buckets(*sort_by_bucket(ids, vals, num_rows, bits),
                              num_rows, bits)
    else:
        out = _launch(*sort_updates(ids, num_rows), vals.contiguous(),
                      num_rows, transposed)
    kernels.count(_KERNEL)
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


# the row gather (csrc/gather_rows.cu): the vector widths it copies in,
# widest first
_GATHER = "gather_rows"
_GATHER_WIDTHS = (16, 8, 4, 2, 1)


def gather_width(row_bytes: int, *addresses: int) -> Tuple[int, int]:
    """(width, lanes): the widest of 16, 8, 4, 2 and 1 bytes that divides
    ``row_bytes`` and every address (the table's and the output's), and
    the vectors of that width a row holds.  A D=4 f32 row is one 16-byte
    vector, a D=8 f32 row two, a D=3 f32 row three of 4 bytes."""
    if row_bytes < 1:
        raise ValueError(f"a row of {row_bytes} bytes")
    for width in _GATHER_WIDTHS:
        if row_bytes % width == 0 and all(a % width == 0 for a in addresses):
            return width, row_bytes // width
    raise AssertionError("every row width is a whole number of bytes")


def _gather_rows_plain(table: torch.Tensor, ids: torch.Tensor
                       ) -> torch.Tensor:
    return table.index_select(0, ids)


def _gather_rows_cuda(table: torch.Tensor, ids: torch.Tensor
                      ) -> torch.Tensor:
    """One launch of the row-gather kernel (counted in ``LAUNCHES``) into a
    new (n, D) tensor; none for n = 0.  A table that is not contiguous is
    copied first."""
    if ids.device != table.device:
        raise ValueError(f"ids on {ids.device}, table on {table.device}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be int32 or int64, got {ids.dtype}")
    table, ids = table.contiguous(), ids.contiguous()
    num_rows, d = table.shape
    n = ids.numel()
    out = torch.empty(n, d, dtype=table.dtype, device=table.device)
    row_bytes = d * table.element_size()
    if n == 0 or row_bytes == 0:
        return out
    width, _ = gather_width(row_bytes, table.data_ptr(), out.data_ptr())
    kernels.launch(_GATHER, _GATHER, table.device, table.data_ptr(),
                   ids.data_ptr(), int(ids.dtype == torch.int64),
                   out.data_ptr(), n, num_rows, row_bytes, width)
    kernels.count(_GATHER)
    return out


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table.index_select(0, ids)`` for a (M, D) table and (n,) int ids,
    bitwise: on a CUDA table the row-gather kernel, on a CPU table the
    plain version (``index_select``).  An id outside [0, M) is a
    device-side assertion on the card, as under ``index_select``."""
    if table.ndim != 2 or ids.ndim != 1:
        raise ValueError(f"table (M, D) and ids (n,) expected, got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if not table.is_cuda:
        return _gather_rows_plain(table, ids)
    return _gather_rows_cuda(table, ids)


class GatherRows(torch.autograd.Function):
    """table (M, D), ids (...,) int -> (..., D); d table = scatter-add.
    The forward is :func:`take_rows`."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return take_rows(table, ids.reshape(-1)).reshape(
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
