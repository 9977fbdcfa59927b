"""The port's training step on the other grid encodings against the JAX
package (CPU).

The three presets whose encodings the port gained, at ``tiny_test`` widths
(4x64 geometric MLP, 16-wide heads, 8 + 2x4 foreground samples) with the
preset's grid type (``custom``: ``lanczos_voxel``; ``triplaneline`` at its
feature size 8; ``voxel_hash`` with its 16 levels and a 128-wide
geometric MLP), B=2, R=4.  Both sides
start from the JAX ``init_model`` parameters (bridged) and the JAX
``make_mc_cdfs`` uniforms: the loss and its monitors, every parameter's
gradient (the eikonal double backward included) and two train steps.
The geometric init zeroes the weight rows that read the grid features (in
layer 0 and the skip layer), so at init the queries reach neither the loss
nor the table's gradient; those rows get random entries on both sides
(:func:`_open_grid_rows`), so that every query is held here.
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
from ndjir_tpu.train.optim import apply_updates as jax_apply_updates
from ndjir_tpu.train.optim import init_optimizer as jax_init_optimizer

from ndjir_torch.bridge import params_from_numpy, params_to_numpy
from ndjir_torch.config import load_config
from ndjir_torch.ops.grid import GridEncoding
from ndjir_torch.render.loss import total_loss
from ndjir_torch.train.optim import init_optimizer, tree_leaves_with_path
from ndjir_torch.train.trainer import train_step

torch.set_num_threads(2)

B, R = 2, 4
CAR, LVG = 0.37, 0.9
LR_W, LR_F = 1e-3, 2e-3
PRESETS = {
    "custom": ["geometric_network.voxel.type=lanczos_voxel"],
    "triplaneline": ["geometric_network.voxel.type=triplaneline",
                     "geometric_network.voxel.feature_size=8"],
    # 16 levels of 4: 64 grid channels, too wide for a 64-wide skip layer
    "voxel_hash": ["geometric_network.voxel.type=voxel_hash",
                   "geometric_network.feature_size=128"],
}

# the scale of the opened grid rows (:func:`_open_grid_rows`) for the
# gradient test and for the two steps.  The voxel hash's finest level
# (G=7,005) amplifies a sample position's ulp ~4,700-fold, so where the
# queries make nearly all of its table gradient a 1-ulp shift of the camera
# moves the JAX package's own gradient by about that test's tolerance; at
# 0.003 they make about half of it.  Its first Adam step moves each hash
# entry by lr * sign(g), and the same shift then moves the JAX package's
# own second loss by more than 1e-4: its two steps start from the closed
# rows
ROW_SCALE = {"custom": (0.1, 0.1), "triplaneline": (0.1, 0.1),
             "voxel_hash": (0.003, 0.0)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _open_grid_rows(params, channels, scale, seed=3):
    """``params`` with the weight rows that read the ``channels`` grid
    features (the last rows of layer 0 and of the skip layer, all zero
    under the geometric init) drawn N(0, (scale * s)^2), s the std of the
    layer's other rows."""
    rng = np.random.RandomState(seed)
    geo = dict(params["geometric-network"])
    for name, layer in geo.items():
        if not name.startswith("affine-") or np.any(layer["W"][-channels:]):
            continue
        W = np.array(layer["W"])
        s = W[:-channels][np.any(W[:-channels], axis=1)].std()
        W[-channels:] = scale * s * rng.randn(channels, W.shape[1])
        geo[name] = dict(layer, W=W.astype(layer["W"].dtype))
    return dict(params, **{"geometric-network": geo})


@pytest.fixture(scope="module", params=list(PRESETS))
def ref(request):
    """Inputs, and the reference's loss, monitors and gradients, and its
    parameters after two steps, for one preset's encoding."""
    overrides = PRESETS[request.param]
    jconf = jax_load_config("tiny_test", overrides=overrides)
    rng = np.random.RandomState(7)
    camloc = np.tile(np.asarray([[0.1, -0.2, 2.5]], np.float32), (B, 1))
    raydir = rng.randn(B, R, 3).astype(np.float32) \
        - np.asarray([0.0, 0.0, 3.0], np.float32)
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    color = rng.rand(B, R, 3).astype(np.float32)
    obj_mask = np.ones((B, R, 1), np.float32)
    batch = (camloc, raydir, color, obj_mask)
    conf = load_config("tiny_test", overrides=overrides)
    closed = _np(jax.jit(lambda k: jax_init_model(k, jconf))(
        jax.random.PRNGKey(0)))
    channels = GridEncoding(conf.geometric_network.voxel).out_dim
    grad_scale, step_scale = ROW_SCALE[request.param]
    params = _open_grid_rows(closed, channels, grad_scale)
    cdfs = _np(jax.jit(lambda: jax_make_mc_cdfs(jconf, B, R))())

    def lossfn(pp):
        return jax_total_loss(pp, *map(jnp.asarray, batch), jnp.float32(CAR),
                              jnp.float32(LVG), jconf, cdfs=cdfs)
    vg = jax.jit(jax.value_and_grad(lossfn, has_aux=True))
    update = jax.jit(lambda p, g, s: jax_apply_updates(
        p, g, s, jnp.float32(LR_W), jnp.float32(LR_F), jconf))

    (loss, mons), grads = vg(params)
    out = dict(name=request.param, conf=conf,
               batch=batch, params=params, cdfs=cdfs, loss=float(loss),
               mons={k: float(v) for k, v in mons.items()}, grads=_np(grads),
               closed_grid_grads=_np(vg(closed)[1]["geometric-network"][
                   "grid"]))
    p = out["step_params"] = _open_grid_rows(closed, channels, step_scale)
    s, g = jax_init_optimizer(p), vg(p)[1]
    for step in range(2):
        p, s, finite = update(p, g, s)
        assert bool(finite)
        if step == 0:
            (loss2, _), g = vg(p)
            out["loss2"] = float(loss2)
    out["after_two_steps"] = _np(p)
    return out


def _torch_inputs(ref, key="params"):
    params = params_from_numpy(ref[key], device="cpu")
    batch = [torch.from_numpy(a) for a in ref["batch"]]
    cdfs = {k: [torch.from_numpy(u) for u in v] if isinstance(v, list)
            else torch.from_numpy(v) for k, v in ref["cdfs"].items()}
    return params, batch, cdfs


def test_grid_leaves_are_the_presets(ref):
    grid = ref["params"]["geometric-network"]["grid"]
    want = {"custom": {"F"}, "triplaneline": {"plane_F", "line_F"},
            "voxel_hash": {"F"}}[ref["name"]]
    assert set(grid) == want


def test_loss_monitors_and_every_grad_match(ref):
    params, batch, cdfs = _torch_inputs(ref)
    # the queries reach the table's gradient: with the rows that read the
    # grid closed, each grid leaf's gradient is its TV term's alone
    for k, g in ref["grads"]["geometric-network"]["grid"].items():
        tv_only = ref["closed_grid_grads"][k]
        assert np.abs(g - tv_only).max() > 0.1 * np.abs(g).max(), k
    leaves = list(tree_leaves_with_path(params))
    for _, p in leaves:
        p.requires_grad_(True)
    loss, mons = total_loss(params, *batch, CAR, LVG, ref["conf"], cdfs=cdfs)
    grads = torch.autograd.grad(loss, [p for _, p in leaves],
                                allow_unused=True)
    # f32 reassociation over the batch's reductions: 1e-4 relative
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-4)
    assert set(mons) == set(ref["mons"])
    for k, v in ref["mons"].items():
        np.testing.assert_allclose(float(mons[k]), v, rtol=1e-4, atol=1e-8,
                                   err_msg=k)
    assert len(leaves) == len(jax.tree_util.tree_leaves(ref["grads"]))
    for (path, _), g in zip(leaves, grads):
        w = _leaf(ref["grads"], path)
        g = np.zeros_like(w) if g is None else g.numpy()
        # the double-backward chains reassociate in f32: each leaf's
        # gradient agrees to 1e-3 of that leaf's largest entry
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max() + 1e-12, path


def test_two_train_steps_match(ref):
    params, batch, cdfs = _torch_inputs(ref, "step_params")
    state = init_optimizer(params)
    mons = [train_step(params, state, *batch, CAR, LVG, LR_W, LR_F,
                       ref["conf"], cdfs=cdfs) for _ in range(2)]
    assert all(bool(m["grads_finite"]) for m in mons)
    np.testing.assert_allclose(float(mons[1]["loss"]), ref["loss2"],
                               rtol=1e-4)
    got = params_to_numpy(params)
    moved, n = 0, 0
    for path, w in tree_leaves_with_path(ref["after_two_steps"]):
        diff = np.abs(_leaf(got, path) - w)
        # each Adam step moves an entry by ~lr * sign(g); where |g| is at
        # f32 noise the sign may differ: at most 2 lr a step, and nearly
        # every entry far tighter (as tests/test_torch_slice.py)
        assert diff.max() <= 4 * LR_F, path
        moved += int(np.sum(diff > 1e-2 * LR_W))
        n += w.size
    assert moved <= 1e-3 * n, (moved, n)
