"""The port's training opt-ins against the JAX package's (CPU):
``train.remat_heads`` and ``renderer.fixed_graph_seeds: false``.

``tiny_test`` widths (every head), B=2, R=4.  Both sides start from the JAX
``init_model`` parameters (bridged) and take the same uniforms: the port's
fresh draw for step 3, handed to the JAX step as numpy.  Tolerances are
those of ``tests/test_torch_slice.py``: the loss at rtol 1e-5, monitors at
rtol 1e-4 (atol 1e-8), each gradient leaf within 1e-3 of its largest
entry.  Rematerialized heads recompute the same float32 operations, so on
the CPU remat and no remat are held bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.models.fields import init_model as jax_init_model
from ndjir_tpu.render.loss import total_loss as jax_total_loss

import ndjir_torch.train.trainer as ttrainer
from ndjir_torch.bridge import params_from_numpy
from ndjir_torch.config import load_config
from ndjir_torch.data.dataset import IDRDataset
from ndjir_torch.data.synthetic import render_sphere_scene
from ndjir_torch.render.renderer import make_mc_cdfs, mc_seed
from ndjir_torch.train.optim import tree_leaves_with_path
from ndjir_torch.train.trainer import loss_and_grads

torch.set_num_threads(2)

B, R = 2, 4
STEP = 3
CAR, LVG = 0.37, 0.9
OPT_INS = ["train.remat_heads=true", "renderer.fixed_graph_seeds=false"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch():
    rng = np.random.RandomState(7)
    camloc = np.tile(np.float32([[0.1, -0.2, 2.5]]), (B, 1))
    raydir = rng.randn(B, R, 3).astype(np.float32) \
        - np.float32([0.0, 0.0, 3.0])
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    color = rng.rand(B, R, 3).astype(np.float32)
    return camloc, raydir, color, np.ones((B, R, 1), np.float32)


@pytest.fixture(scope="module")
def ref():
    """The JAX step with remat_heads on, handed the port's fresh uniforms
    of step ``STEP``."""
    jconf = jax_load_config("tiny_test", overrides=OPT_INS)
    params = _np(jax_init_model(jax.random.PRNGKey(0), jconf))
    cdfs = make_mc_cdfs(load_config("tiny_test", overrides=OPT_INS), B, R,
                        step=STEP, device="cpu")
    ncdfs = {k: [u.numpy() for u in v] if isinstance(v, list) else v.numpy()
             for k, v in cdfs.items()}
    batch = _batch()

    def lossfn(p):
        return jax_total_loss(p, *map(jnp.asarray, batch), jnp.float32(CAR),
                              jnp.float32(LVG), jconf, cdfs=ncdfs)

    (loss, mons), g = jax.jit(jax.value_and_grad(lossfn, has_aux=True))(
        params)
    return dict(params=params, cdfs=cdfs, batch=batch, loss=float(loss),
                mons={k: float(v) for k, v in mons.items()}, grads=_np(g))


def _port(ref, remat: bool):
    conf = load_config("tiny_test", overrides=[
        f"train.remat_heads={str(remat).lower()}",
        "renderer.fixed_graph_seeds=false"])
    params = params_from_numpy(ref["params"], device="cpu")
    batch = [torch.from_numpy(a) for a in ref["batch"]]
    return loss_and_grads(params, *batch, CAR, LVG, conf, cdfs=ref["cdfs"])


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_step_matches_jax_remat(ref, remat):
    """Loss, monitors and every gradient of the port's step, with and
    without rematerialized heads, against the JAX step with them."""
    loss, mons, grads = _port(ref, remat)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    assert set(mons) == set(ref["mons"])
    for k, v in ref["mons"].items():
        np.testing.assert_allclose(float(mons[k]), v, rtol=1e-4, atol=1e-8,
                                   err_msg=k)
    for path, g in tree_leaves_with_path(grads):
        w = _leaf(ref["grads"], path)
        assert np.abs(g.numpy() - w).max() \
            <= 1e-3 * np.abs(w).max() + 1e-12, path


def test_remat_equals_no_remat_bitwise(ref):
    loss, mons, grads = _port(ref, True)
    loss0, mons0, grads0 = _port(ref, False)
    assert torch.equal(loss, loss0)
    for k in mons:
        assert torch.equal(mons[k], mons0[k]), k
    for (path, g), (_, g0) in zip(tree_leaves_with_path(grads),
                                  tree_leaves_with_path(grads0)):
        assert torch.equal(g, g0), path


def test_remat_recomputes_the_heads(ref, monkeypatch):
    """With remat_heads the heads run again in the backward pass: twice as
    many base-color head calls as without."""
    import ndjir_torch.render.renderer as renderer

    calls = []
    real = renderer._HEADS["base_color"]

    def counted(*a, **k):
        calls.append(torch.is_grad_enabled())
        return real(*a, **k)

    monkeypatch.setitem(renderer._HEADS, "base_color", counted)
    _port(ref, False)
    plain = len(calls)
    calls.clear()
    _port(ref, True)
    assert plain == 2 and len(calls) == 2 * plain


def test_fresh_uniforms_per_step():
    """With fixed_graph_seeds false every input, the perturbation's normal
    draw too, differs between steps and repeats for a step; uniforms lie
    in [0, 1).  With fixed seeds the step is ignored."""
    conf = load_config("tiny_test", overrides=OPT_INS)
    fixed = load_config("tiny_test")
    a = make_mc_cdfs(conf, B, R, step=4, device="cpu")
    b = make_mc_cdfs(conf, B, R, step=5, device="cpu")
    a2 = make_mc_cdfs(conf, B, R, step=4, device="cpu")
    for k, v in a.items():
        for u, w, u2 in zip(*(x if isinstance(x, list) else [x]
                              for x in (v, b[k], a2[k]))):
            assert not torch.equal(u, w), k
            assert torch.equal(u, u2), k
            if k != "perturb":
                assert float(u.min()) >= 0.0 and float(u.max()) < 1.0, k
    f4 = make_mc_cdfs(fixed, B, R, step=4, device="cpu")
    f0 = make_mc_cdfs(fixed, B, R, device="cpu")
    for k in f4:
        assert torch.equal(f4[k] if k != "upsample" else f4[k][0],
                           f0[k] if k != "upsample" else f0[k][0]), k
    assert mc_seed(7, None) == 7
    assert mc_seed(7, 3) == 7 * 2 ** 32 + 3
    with pytest.raises(ValueError):
        mc_seed(7, 2 ** 32)


def test_trainer_draws_each_steps_uniforms(tmp_path, monkeypatch):
    """The trainer keeps no cached draw with fresh seeds and hands step g
    the draw of g."""
    conf = load_config("tiny_test", overrides=OPT_INS + [
        "valid.skip=true", f"monitor_base_path={tmp_path}/mon"])
    images, masks, cameras = render_sphere_scene(n_views=4, H=16, W=16)
    ds = IDRDataset(conf, images, masks, cameras, train=True, shuffle=True)
    tr = ttrainer.Trainer(conf, dataset=ds, device="cpu")
    assert tr.cdfs is None
    seen = []
    real = ttrainer.train_step

    def spy(*a, cdfs=None, step=None, **k):
        want = make_mc_cdfs(conf, conf.train.batch_size, conf.train.n_rays,
                            step=step, device="cpu")
        seen.append((step, torch.equal(cdfs["stratified"],
                                       want["stratified"])))
        return real(*a, cdfs=cdfs, step=step, **k)

    monkeypatch.setattr(ttrainer, "train_step", spy)
    tr.train()
    assert seen == [(g, True) for g in range(4)]
    assert all(np.isfinite(m["loss"]) for m in tr.history)
