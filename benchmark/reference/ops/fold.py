"""Octa cotangent fold, the backward of the octa table build, in plain
PyTorch: a frozen copy of the plain form of ``ndjir_torch/ops/fold.py``
for the benchmark's reference (three halving passes, x then y then z).
"""

from __future__ import annotations

import torch

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


def fold_octa_cotangent(cot_t: torch.Tensor, gshape,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """(8D, Gx*Gy*Gz) f32 octa-row cotangent -> (Gx, Gy, Gz, D) base-table
    cotangent in ``out_dtype``, summed in f32 and rounded once."""
    return _fold_octa_cotangent_plain(cot_t.float(), gshape, out_dtype)
