#!/usr/bin/env python3
"""The initial SDF field of a draw of initial weights, from either package.

    JAX_PLATFORMS=cpu python3 scripts/init_field_stats.py jax 0 1 2
    python3 scripts/init_field_stats.py torch 0 1 2

The default config with a G=64 f32 grid and bounding-sphere radius 0.75
(the quality benchmark's), at 20,000 points drawn uniformly from the cube
[-0.75, 0.75]^3 (numpy seed 0).  For each draw (``jax``: the JAX
package's ``init_model(PRNGKey(k))``; ``torch``: the port's
``init_model(seed=k)``) it prints the offset of the SDF from the r=0.5
sphere's, ``sdf(x) - (|x| - 0.5)``, as mean +- std, and |grad_x sdf| as
mean (min-max).  It imports only the package it is asked for and runs on
the CPU in seconds.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OVERRIDES = ["geometric_network.voxel.grid_size=64",
             "renderer.bounding_sphere_radius=0.75"]
N_POINTS, RADIUS = 20_000, 0.75


def points() -> np.ndarray:
    rng = np.random.RandomState(0)
    return rng.uniform(-RADIUS, RADIUS, (N_POINTS, 3)).astype(np.float32)


def jax_field(key: int):
    import jax

    from ndjir_tpu.config import load_config
    from ndjir_tpu.models.fields import init_model
    from ndjir_tpu.render.renderer import sdf_value_and_spatial_grad

    conf = load_config("default", overrides=OVERRIDES)
    params = init_model(jax.random.PRNGKey(key), conf)
    sdf, _, _, grad, _ = sdf_value_and_spatial_grad(params, points(), conf)
    return np.asarray(sdf)[:, 0], np.asarray(grad)


def torch_field(seed: int):
    import torch

    from ndjir_torch.config import load_config
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.render.renderer import sdf_value_and_spatial_grad

    conf = load_config("default", overrides=OVERRIDES)
    params = init_model(conf, seed=seed, device="cpu")
    sdf, _, _, grad, _ = sdf_value_and_spatial_grad(
        params, torch.from_numpy(points()), conf)
    return sdf.detach().numpy()[:, 0], grad.detach().numpy()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2 or argv[0] not in ("jax", "torch"):
        print(__doc__, file=sys.stderr)
        return 2
    field = jax_field if argv[0] == "jax" else torch_field
    x = points()
    sphere = np.linalg.norm(x, axis=1) - 0.5
    for k in map(int, argv[1:]):
        sdf, grad = field(k)
        off = sdf - sphere
        gn = np.linalg.norm(grad, axis=1)
        name = f"PRNGKey({k})" if argv[0] == "jax" else f"seed {k}"
        print(f"{argv[0]} {name}: offset from the r=0.5 sphere "
              f"{off.mean():.3f} +- {off.std():.3f}; |grad sdf| "
              f"{gn.mean():.3f} ({gn.min():.3f}-{gn.max():.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
