"""One training step's loss and gradients at a 128-ray batch, the port on
the CPU against the JAX reference, at f32 and bf16 MLP operands.

``tests/test_torch_slice.py`` holds a step at 8 rays to f32 rounding.  At
128 rays (full widths, the quality benchmark's overrides, a G=64 grid) the
grid's gradient is a sum over ~20,000 samples of terms that mostly cancel,
so even at f32 the two part by more than the MLP leaves do.  With bf16
operands the two implementations round in different places (the
reference's softplus rounds after each bf16 op, the port's once; XLA on
the CPU keeps excess precision), and the gradients part in proportion:
this test records how far, which is what a card-against-CPU comparison at
bf16 can be held to (``scripts/torch_quality_diagnosis.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.models.fields import init_model as jax_init_model
from ndjir_tpu.render.loss import total_loss as jax_total_loss
from ndjir_tpu.render.renderer import make_mc_cdfs as jax_make_mc_cdfs

from ndjir_torch.bridge import params_from_numpy
from ndjir_torch.config import load_config
from ndjir_torch.train.optim import tree_leaves_with_path
from ndjir_torch.train.trainer import loss_and_grads

torch.set_num_threads(2)

B, R = 2, 64
CAR, LVG = 0.6, 0.8
OVERRIDES = ["geometric_network.voxel.grid_size=64", "train.mask_weight=0.1",
             "renderer.bounding_sphere_radius=0.75"]
# (loss rtol, bound on every leaf's max |port - JAX| / its largest entry,
# bound on every leaf's |port - JAX| / |JAX|); the grid's gradient comes
# nearest both: 0.0083 and 0.0048 at f32, 0.099 and 0.18 at bf16
TOLS = {"float32": (1e-5, 2e-2, 1e-2), "bfloat16": (2e-3, 0.2, 0.3)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mlp_dtype", sorted(TOLS))
def test_step_at_a_128_ray_batch(mlp_dtype):
    overrides = OVERRIDES + [f"precision.mlp_dtype={mlp_dtype}"]
    jconf = jax_load_config("default", overrides=overrides)
    rng = np.random.RandomState(7)
    camloc = np.tile(np.asarray([[0.1, -0.2, 2.5]], np.float32), (B, 1))
    raydir = rng.randn(B, R, 3).astype(np.float32) * 0.15 \
        - np.asarray([0.0, 0.0, 1.0], np.float32)
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    color = rng.rand(B, R, 3).astype(np.float32)
    mask = (rng.rand(B, R, 1) > 0.3).astype(np.float32)
    batch = (camloc, raydir, color, mask)
    params = _np(jax.jit(lambda k: jax_init_model(k, jconf))(
        jax.random.PRNGKey(0)))
    cdfs = _np(jax.jit(lambda: jax_make_mc_cdfs(jconf, B, R))())
    (want_loss, _), want = jax.jit(jax.value_and_grad(
        lambda p: jax_total_loss(p, *map(jnp.asarray, batch),
                                 jnp.float32(CAR), jnp.float32(LVG), jconf,
                                 cdfs=cdfs), has_aux=True))(params)
    want = _np(want)

    conf = load_config("default", overrides=overrides)
    loss, _, grads = loss_and_grads(
        params_from_numpy(params, device="cpu", conf=conf),
        *[torch.from_numpy(a) for a in batch], CAR, LVG, conf,
        cdfs={k: [torch.tensor(u) for u in v] if isinstance(v, list)
              else torch.tensor(v) for k, v in cdfs.items()})
    loss_rtol, max_tol, norm_tol = TOLS[mlp_dtype]
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=loss_rtol)
    for path, g in tree_leaves_with_path(grads):
        g = g.double().numpy()
        w = np.asarray(_leaf(want, path), np.float64)
        d = g - w
        name = "/".join(path)
        assert np.abs(d).max() <= max_tol * np.abs(w).max() + 1e-30, name
        assert np.linalg.norm(d) <= norm_tol * np.linalg.norm(w) + 1e-30, \
            name
