"""Small constant tensors on a device, made once.

``torch.tensor(values, device="cuda")`` copies from pageable host memory
and waits for the copy, which drains the launch queue and cannot be
captured in a CUDA graph.  :func:`device_const` makes each (values, dtype,
device) once, with a copy from pinned memory that does not wait, and
hands out the same tensor afterwards.  Callers must not write to it.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

_CACHE: Dict[Tuple, torch.Tensor] = {}


def device_const(values: Sequence, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """A tensor of ``values`` (a number or a nested sequence of numbers)
    in ``dtype`` on ``device``, cached."""
    device = torch.device(device)
    key = (_frozen(values), dtype, device)
    t = _CACHE.get(key)
    if t is None:
        t = torch.tensor(values, dtype=dtype)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        _CACHE[key] = t
    return t


def _frozen(values):
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return values
