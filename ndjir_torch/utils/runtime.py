"""Runtime setup and device queries (the port's counterpart of
``ndjir_tpu/utils/runtime.py``).

The JAX package keeps a persistent XLA compilation cache
(``setup_compilation_cache``) because its first compile of the render graph
takes minutes.  PyTorch runs eagerly and compiles no graph, so the port has
no such cache and no such function.  What it does compile, its hand-written
CUDA kernels, it builds once into ``ndjir_torch/csrc/build/``
(:func:`ndjir_torch.kernels.library_path`, one file per source and flags),
and that directory is the port's cache.
"""

from __future__ import annotations


def device_kind() -> str:
    """The name of CUDA device 0, e.g. ``NVIDIA H100 80GB HBM3``."""
    import torch

    return torch.cuda.get_device_name(0)
