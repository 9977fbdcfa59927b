"""The port's training step as a whole against the JAX reference (CPU).

Default network architecture (8x256 geometric MLP, every head, Filament
importance BRDF, 128 fg + 32 bg samples, 2x128 light dirs) at the size of
tests/test_parity_oracle.py: G=48, B=2, R=4.  Both sides start from the
JAX ``init_model`` parameters (converted by ``ndjir_torch.bridge``) and the
JAX ``make_mc_cdfs`` uniforms, all as numpy.

Layouts: at G=48 the JAX package takes its z-dup table and the fused
perturbed query, because 48^3 x 2 x 4 x 4 B is under ``_ZDUP_MAX_BYTES``;
at the default G=512 it takes the 8-corner branch that the port always
takes.  The reference side therefore runs twice, as is and with the budget
at 0.  The layout is decided while tracing, so each reference function is
jitted here through a closure made inside its layout's context: no trace
cached elsewhere (``train_step``'s, say) can stand in for it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ndjir_tpu.ops.grid as jgrid
from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.models.fields import init_model as jax_init_model
from ndjir_tpu.render.loss import total_loss as jax_total_loss
from ndjir_tpu.render.renderer import make_mc_cdfs as jax_make_mc_cdfs
from ndjir_tpu.render.sampler import sample_points as jax_sample_points
from ndjir_tpu.train.optim import apply_updates as jax_apply_updates
from ndjir_tpu.train.optim import init_optimizer as jax_init_optimizer

from ndjir_torch.bridge import params_from_numpy, params_to_numpy
from ndjir_torch.config import load_config
from ndjir_torch.models.fields import init_model
from ndjir_torch.render.loss import total_loss
from ndjir_torch.render.sampler import sample_points
from ndjir_torch.train.optim import apply_updates, init_optimizer
from ndjir_torch.train.optim import tree_leaves_with_path
from ndjir_torch.train.trainer import train_step

torch.set_num_threads(2)

B, R = 2, 4
OVERRIDES = ["geometric_network.voxel.grid_size=48"]
CAR, LVG = 0.37, 0.9          # mid-schedule cos-anneal ratio and lv gain
LR_W, LR_F = 1e-3, 2e-3       # distinct, so the feature/weight split shows


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _torch_cdfs(cdfs):
    return {k: [torch.from_numpy(u) for u in v] if isinstance(v, list)
            else torch.from_numpy(v) for k, v in cdfs.items()}


@pytest.fixture(scope="module")
def ref():
    """Inputs, and the reference's loss, monitors and gradients per layout
    plus its second step (8-corner layout)."""
    jconf = jax_load_config("default", overrides=OVERRIDES)
    rng = np.random.RandomState(7)
    camloc = np.tile(np.asarray([[0.1, -0.2, 2.5]], np.float32), (B, 1))
    raydir = rng.randn(B, R, 3).astype(np.float32) \
        - np.asarray([0.0, 0.0, 3.0], np.float32)
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    color = rng.rand(B, R, 3).astype(np.float32)
    obj_mask = np.ones((B, R, 1), np.float32)
    batch = (camloc, raydir, color, obj_mask)
    params = _np(jax.jit(lambda k: jax_init_model(k, jconf))(
        jax.random.PRNGKey(0)))
    cdfs = _np(jax.jit(lambda: jax_make_mc_cdfs(jconf, B, R))())

    def make_value_and_grad():
        def lossfn(pp):
            return jax_total_loss(pp, *map(jnp.asarray, batch),
                                  jnp.float32(CAR), jnp.float32(LVG), jconf,
                                  cdfs=cdfs)
        vg = jax.jit(jax.value_and_grad(lossfn, has_aux=True))

        def value_and_grad(p):
            (loss, mons), g = vg(p)
            return float(loss), {k: float(v) for k, v in mons.items()}, _np(g)
        return value_and_grad

    out = dict(conf=load_config("default", overrides=OVERRIDES), batch=batch,
               params=params, cdfs=cdfs)
    ref_gshape = params["geometric-network"]["grid"]["F"].shape
    assert jgrid.use_zdup_layout(ref_gshape)
    out["zdup"] = make_value_and_grad()(params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgrid, "_ZDUP_MAX_BYTES", 0)
        assert not jgrid.use_zdup_layout(ref_gshape)
        value_and_grad = make_value_and_grad()
        out["8corner"] = value_and_grad(params)
        samples = jax.jit(lambda p: jax_sample_points(
            p, *map(jnp.asarray, batch[:2]), cdfs["stratified"],
            cdfs["background"], jconf, rand_u=cdfs["upsample"]))(params)
        out["samples"] = _np(samples)
        # two reference train steps: the body of
        # ndjir_tpu.train.trainer.train_step
        update = jax.jit(lambda p, g, s: jax_apply_updates(
            p, g, s, jnp.float32(LR_W), jnp.float32(LR_F), jconf))
        p, s = params, jax_init_optimizer(params)
        g = out["8corner"][2]
        for step in range(2):
            p, s, finite = update(p, g, s)
            assert bool(finite)
            if step == 0:
                out["after_one_update"] = _np(p)
                _, out["step2_monitors"], g = value_and_grad(p)
        out["after_two_steps"] = _np(p)
    return out


def _torch_inputs(ref):
    params = params_from_numpy(ref["params"], device="cpu")
    batch = [torch.from_numpy(a) for a in ref["batch"]]
    return params, batch, _torch_cdfs(ref["cdfs"])


def _torch_value_and_grad(ref):
    params, batch, cdfs = _torch_inputs(ref)
    leaves = list(tree_leaves_with_path(params))
    for _, p in leaves:
        p.requires_grad_(True)
    loss, mons = total_loss(params, *batch, CAR, LVG, ref["conf"], cdfs=cdfs)
    grads = torch.autograd.grad(loss, [p for _, p in leaves],
                                allow_unused=True)
    return loss, mons, leaves, grads


def test_sample_points_match(ref):
    params, batch, cdfs = _torch_inputs(ref)
    got = sample_points(params, *batch[:2], cdfs["stratified"],
                        cdfs["background"], ref["conf"],
                        rand_u=cdfs["upsample"])
    names = ["x_fg", "t_fg", "x_bg", "t_bg", "mask"]
    for name, g, want in zip(names, got, ref["samples"]):
        assert g.shape == want.shape, name
        diff = np.abs(g.numpy() - want)
        # f32 cumsums reassociate: the bulk agrees to rounding, and a
        # sample whose inverse-CDF key sits on a bin edge may land one
        # section over (tests/test_parity_oracle.py bounds it the same way)
        assert np.quantile(diff, 0.99) < 1e-4, name
        assert diff.max() < 0.05, name
    np.testing.assert_array_equal(got[4].numpy(), ref["samples"][4])


@pytest.mark.parametrize("layout", ["zdup", "8corner"])
def test_total_loss_and_monitors_match(ref, layout):
    loss, mons, _, _ = _torch_value_and_grad(ref)
    want_loss, want_mons, _ = ref[layout]
    # f32 reassociation over ~10^5-term reductions: 1e-5 relative
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert set(mons) == set(want_mons)
    for k, v in want_mons.items():
        np.testing.assert_allclose(float(mons[k]), v, rtol=1e-4, atol=1e-8,
                                   err_msg=k)


@pytest.mark.parametrize("layout", ["zdup", "8corner"])
def test_every_param_grad_matches(ref, layout):
    _, _, leaves, grads = _torch_value_and_grad(ref)
    want = ref[layout][2]
    assert len(leaves) == len(jax.tree_util.tree_leaves(want))
    for (path, _), g in zip(leaves, grads):
        w = _leaf(want, path)
        g = np.zeros_like(w) if g is None else g.numpy()
        # the double-backward chains reassociate in f32: each leaf's
        # gradient agrees to 1e-3 of that leaf's largest entry
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 1e-3 * scale + 1e-12, path


def test_apply_updates_matches_on_shared_grads(ref):
    """One optimizer step from the same (reference) gradients."""
    params = params_from_numpy(ref["params"], device="cpu")
    grads = params_from_numpy(ref["8corner"][2], device="cpu")
    state = init_optimizer(params)
    assert apply_updates(params, grads, state, LR_W, LR_F, ref["conf"])
    assert state["count"] == 1
    got = params_to_numpy(params)
    for path, w in tree_leaves_with_path(ref["after_one_update"]):
        # same arithmetic up to f32 rounding of the update (|step| <= ~lr)
        np.testing.assert_allclose(_leaf(got, path), w, rtol=1e-6,
                                   atol=1e-5 * LR_F, err_msg=str(path))


def test_two_train_steps_match(ref):
    params, batch, cdfs = _torch_inputs(ref)
    state = init_optimizer(params)
    mons = [train_step(params, state, *batch, CAR, LVG, LR_W, LR_F,
                       ref["conf"], cdfs=cdfs) for _ in range(2)]
    assert all(bool(m["grads_finite"]) for m in mons)
    assert state["count"] == 2
    np.testing.assert_allclose(float(mons[1]["loss"]),
                               ref["step2_monitors"]["loss"], rtol=1e-4)
    got = params_to_numpy(params)
    moved = 0
    for path, w in tree_leaves_with_path(ref["after_two_steps"]):
        diff = np.abs(_leaf(got, path) - w)
        # each Adam step moves an entry by ~lr * sign(g); where |g| is at
        # f32 noise the sign may differ, so bound by 2 lr per step, and
        # require nearly every entry to agree far tighter
        assert diff.max() <= 4 * LR_F, path
        moved += int(np.sum(diff > 1e-2 * LR_W))
    n = sum(w.size for _, w in tree_leaves_with_path(ref["after_two_steps"]))
    assert moved <= 1e-3 * n, (moved, n)


def test_native_init_structure_and_statistics(ref):
    """The port's own SAL geometric init: the reference's keys and shapes,
    and the statistics the initializer prescribes (not the same draws)."""
    conf = ref["conf"]
    got = params_to_numpy(init_model(conf, seed=0, device="cpu"))
    want = ref["params"]
    got_leaves = dict(tree_leaves_with_path(got))
    want_leaves = dict(tree_leaves_with_path(want))
    assert set(got_leaves) == set(want_leaves)
    for path, w in want_leaves.items():
        assert got_leaves[path].shape == w.shape, path

    geo = got["geometric-network"]
    D = conf.geometric_network.feature_size
    W0 = geo["affine-00"]["W"]
    assert np.all(W0[3:] == 0)                      # only raw x feeds layer 0
    assert abs(W0[:3].std() / np.sqrt(2.0 / D) - 1) < 0.15
    W4 = geo["affine-04"]["W"]                      # the skip layer
    Din = W0.shape[0]
    assert np.all(W4[D - Din:] == 0)
    last = geo["affine-last"]
    assert abs(last["W"][:, 0].mean() / np.sqrt(np.pi / D) - 1) < 1e-3
    np.testing.assert_array_equal(
        last["b"], np.float32(-conf.geometric_network.initial_sphere_radius))
    assert abs(geo["grid"]["F"].std() / 1e-3 - 1) < 0.01
    np.testing.assert_allclose(geo["gain"], [conf.train.sigmoid_gain])


def test_native_init_law_matches_per_leaf(ref):
    """Every leaf of the port's own init against the JAX package's at the
    default (the quality benchmark's) MLP widths: constant leaves equal,
    drawn leaves of n entries with the same mean and spread, within five
    times the sampling noise of two independent draws (mean: std
    sqrt(2/n); ratio of the standard deviations: sqrt(1/n))."""
    got = dict(tree_leaves_with_path(params_to_numpy(
        init_model(ref["conf"], seed=0, device="cpu"))))
    for path, w in tree_leaves_with_path(ref["params"]):
        g = got[path]
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(g, w, err_msg=str(path))
            continue
        n = w.size
        assert abs(g.std() / w.std() - 1) < 5 * np.sqrt(1 / n), path
        assert abs(g.mean() - w.mean()) < 5 * w.std() * np.sqrt(2 / n), path
