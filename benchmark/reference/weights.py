"""The weights every run starts from, drawn on the device from a seed by
the published initialization laws (the SAL sphere init of the SDF
network, Glorot-uniform heads, N(0, 1e-3) grid features: a frozen copy of
``init_model``, ``benchmark.reference.models.fields``), and their hand-over
to the program under test.
"""

from __future__ import annotations

import torch

from benchmark.reference.config import Config
from benchmark.reference.models.fields import init_model
from benchmark.reference.train.optim import tree_leaves_with_path


def draw(config: dict, seed: int, device) -> dict:
    """The parameter tree of ``config`` (the configuration dict as run)
    for ``seed``, on ``device``: one generator, a few large draws."""
    return init_model(Config(config), seed=seed, device=device)


@torch.no_grad()
def load_into(params: dict, weights: dict) -> None:
    """Copy ``weights`` into the program's parameter tree in place; the
    two trees must hold the same leaves, shapes and dtypes."""
    mine = dict(tree_leaves_with_path(weights))
    theirs = dict(tree_leaves_with_path(params))
    if mine.keys() != theirs.keys():
        raise ValueError(f"parameter trees differ: {sorted(mine.keys() ^ theirs.keys())}")
    for path, p in theirs.items():
        w = mine[path]
        if p.shape != w.shape or p.dtype != w.dtype:
            raise ValueError(f"{'/'.join(path)}: program {tuple(p.shape)} "
                             f"{p.dtype}, benchmark {tuple(w.shape)} "
                             f"{w.dtype}")
        p.copy_(w)
