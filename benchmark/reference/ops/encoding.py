"""Positional encoding (counterpart of ``ndjir_tpu/ops/encoding.py``).

Output is ``concat([x, cos(2^0 x), ..., cos(2^{M-1} x), sin(...)])`` with the
band axis interleaved per input channel (reference python/network.py:96-117).
"""

from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, M: int = 6,
                        include_input: bool = True) -> torch.Tensor:
    """(..., C) -> (..., C + 2*C*M) frequency features, bands 2^0..2^{M-1},
    per-channel band-major layout (reference: python/network.py:105-110)."""
    if M <= 0:
        return x
    bands = 2.0 ** torch.arange(M, dtype=x.dtype, device=x.device)
    xb = x[..., :, None] * bands  # (..., C, M)
    xb = xb.reshape(*x.shape[:-1], x.shape[-1] * M)
    parts = [x] if include_input else []
    parts += [torch.cos(xb), torch.sin(xb)]
    return torch.cat(parts, dim=-1)


def pe_dim(C: int, M: int, include_input: bool = True) -> int:
    """Output channel count of positional_encoding."""
    if M <= 0:
        return C
    return (C if include_input else 0) + 2 * C * M
