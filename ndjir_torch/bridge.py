"""Parameter trees between numpy and the port.

The port keeps the reference's parameter layout: the same nested keys (the
reference's scope names, including the roughness / specular heads' gappy
``affine--1``), (in, out) affine weights and a (G, G, G, D) voxel grid.  A
reference parameter tree turned into numpy arrays therefore converts leaf
by leaf, with no reshapes or transposes.  numpy has no bfloat16 of its own:
a bf16 leaf comes in as ``ml_dtypes.bfloat16`` (what a JAX bf16 array turns
into) or as float32, which holds every bf16 value exactly, and goes out as
float32.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ndjir_torch.models.fields import param_dtype


def _tensor(a) -> torch.Tensor:
    """A copy of a numpy array as a CPU tensor; an ``ml_dtypes`` bfloat16
    array (a dtype torch.from_numpy does not take) by its bits."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: Dict[str, Any], device="cuda",
                      dtype: torch.dtype | None = None,
                      conf=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (copies).  Float leaves are cast to ``dtype`` when given,
    else, with ``conf``, to the dtype the port's ``init_model`` gives that
    leaf under it (bf16 for the voxel table under
    ``precision.grid_dtype=bfloat16``, f32 elsewhere)."""
    def convert(node, path):
        if isinstance(node, dict):
            return {k: convert(v, path + (k,)) for k, v in node.items()}
        t = _tensor(node)
        if t.is_floating_point():
            if dtype is not None:
                t = t.to(dtype)
            elif conf is not None:
                t = t.to(param_dtype(path, conf))
        return t.to(device)
    return convert(tree, ())


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dict of tensors -> the same dict of numpy arrays; bf16
    leaves as float32 (exact)."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return {k: params_to_numpy(v) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}
