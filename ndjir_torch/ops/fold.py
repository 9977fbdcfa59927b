"""Octa cotangent fold: the backward of the octa table build.

Counterpart of ``ndjir_tpu/ops/fold_pallas.py`` (and of the XLA form it
replaces, ``_fold_octa_cotangent_flat2d`` in ``ndjir_tpu/ops/grid.py``).
The TPU kernel (``_fold_kernel``) becomes ``csrc/fold_octa_cotangent.cu``.

The octa table row of cell (x, y, z) holds the features of its 8 corner
cells (x+dx, y+dy, z+dz), channel block b = dx*4 + dy*2 + dz, each +1
neighbour clamped to the last slice of its axis.  Its backward scatters the
rows' cotangent into a transposed (8D, M) f32 table (M = Gx*Gy*Gz, B1 in
transposed form), and the fold maps that onto the (Gx, Gy, Gz, D) base
table: three halving passes, x then y then z.  Along each axis cell L-1
receives both its shifted neighbour and its own clamped duplicate, so the
far corner cell sums 27 inputs.

On a CPU tensor :func:`fold_octa_cotangent` computes the plain version; on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ndjir_torch import kernels

_KERNEL = "fold_octa_cotangent"
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _fold_halve(c: torch.Tensor, delta: int, L: int) -> torch.Tensor:
    """One halving pass on the flat (2C, M) layout:
    a'[i] = (a[i] + b[i - delta]*[coord(i) >= 1]) + b[i]*[coord(i) == L-1],
    coord(i) = (i // delta) % L."""
    C = c.shape[0] // 2
    a, b = c[:C], c[C:]
    i = torch.arange(c.shape[1], device=c.device)
    coord = (i // delta) % L
    shifted = torch.cat([torch.zeros_like(b[:, :delta]), b[:, :-delta]],
                        dim=1)
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    return a + torch.where(coord >= 1, shifted, zero) \
        + torch.where(coord == L - 1, b, zero)


def _fold_octa_cotangent_plain(cot_t: torch.Tensor, gshape,
                               out_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """The plain version: the three passes in ``cot_t``'s dtype (float64
    gives the exact sums a kernel is checked against), then one transpose
    to (Gx, Gy, Gz, D) and one cast to ``out_dtype``."""
    Gx, Gy, Gz, D = gshape
    c = _fold_halve(cot_t, Gy * Gz, Gx)
    c = _fold_halve(c, Gz, Gy)
    c = _fold_halve(c, 1, Gz)
    return c.t().reshape(Gx, Gy, Gz, D).to(out_dtype)


def _check(cot_t: torch.Tensor, gshape, out_dtype: torch.dtype) -> None:
    Gx, Gy, Gz, D = (int(n) for n in gshape)
    if min(Gx, Gy, Gz, D) < 1:
        raise ValueError(f"bad grid shape {tuple(gshape)}")
    if tuple(cot_t.shape) != (8 * D, Gx * Gy * Gz):
        raise ValueError(f"cotangent {tuple(cot_t.shape)} expected "
                         f"{(8 * D, Gx * Gy * Gz)} for grid {tuple(gshape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")


def _launch(cot_t: torch.Tensor, gshape,
            out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel alone: a new (Gx, Gy, Gz, D) table in ``out_dtype``,
    every element written by the kernel."""
    if not cot_t.is_cuda:
        raise ValueError("the fold kernel takes CUDA tensors")
    if cot_t.dtype != torch.float32 or not cot_t.is_contiguous():
        raise TypeError(f"a contiguous float32 cotangent expected, got "
                        f"{cot_t.dtype}")
    Gx, Gy, Gz, D = (int(n) for n in gshape)
    lib = kernels.load(_KERNEL)
    fn = lib.fold_octa_cotangent
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((Gx, Gy, Gz, D), dtype=out_dtype, device=cot_t.device)
    stream = torch.cuda.current_stream(cot_t.device).cuda_stream
    err = fn(cot_t.data_ptr(), out.data_ptr(), Gx, Gy, Gz, D,
             int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: cudaError {err}")
    return out


def fold_octa_cotangent(cot_t: torch.Tensor, gshape,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """(8D, Gx*Gy*Gz) f32 octa-row cotangent -> (Gx, Gy, Gz, D) base-table
    cotangent in ``out_dtype`` (float32 or bfloat16), summed in f32 and
    rounded once."""
    _check(cot_t, gshape, out_dtype)
    if cot_t.device.type == "cpu":
        return _fold_octa_cotangent_plain(cot_t.float(), gshape, out_dtype)
    if cot_t.device.type == "cuda":
        out = _launch(cot_t, gshape, out_dtype)
        kernels.LAUNCHES[_KERNEL] += 1
        return out
    raise ValueError(f"no fold for device {cot_t.device}")
