"""The port's fused K-step call (``train_steps``) against the JAX package's
(CPU, ``tiny_test`` widths).

Both sides start from the JAX ``init_model`` parameters (converted by
``ndjir_torch.bridge``) and take the JAX ``make_mc_cdfs`` uniforms.  On the
CPU the port's ``train_steps`` runs its step as a loop (on the card it
replays one captured step, which ``chip_smoke.py`` holds against the eager
step), so it must equal K calls of ``train_step`` bitwise.  Also here: the
non-finite skip on the device in both packages, the ``Trainer`` at
``steps_per_call`` 4 against 1, the f32 bias correction, and the schedule
scalars as 0-dim tensors against Python floats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ndjir_tpu.train.optim as jopt
from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.models.fields import init_model as jax_init_model
from ndjir_tpu.render.renderer import make_mc_cdfs as jax_make_mc_cdfs
from ndjir_tpu.train.trainer import train_steps as jax_train_steps

from ndjir_torch.bridge import params_from_numpy, params_to_numpy
from ndjir_torch.config import load_config
from ndjir_torch.data.dataset import IDRDataset
from ndjir_torch.data.synthetic import render_sphere_scene
from ndjir_torch.train.optim import (
    bias_correction,
    init_optimizer,
    tree_leaves_with_path,
)
from ndjir_torch.train.trainer import Trainer, train_step, train_steps

torch.set_num_threads(2)

K, B, R = 3, 2, 16
CAR, LVG = 0.37, 0.9          # mid-schedule cos-anneal ratio and lv gain
LR_W, LR_F = 1e-3, 2e-3       # distinct, so the feature/weight split shows


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _batches(nan_step=None):
    """K batches (camloc, raydir, color, mask), each (K, ...) numpy f32;
    with ``nan_step`` that step's colours are NaN."""
    rng = np.random.RandomState(11)
    camloc = np.tile(np.asarray([[0.1, -0.2, 2.5]], np.float32), (K, B, 1))
    raydir = rng.randn(K, B, R, 3).astype(np.float32) \
        - np.asarray([0.0, 0.0, 3.0], np.float32)
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    color = rng.rand(K, B, R, 3).astype(np.float32)
    if nan_step is not None:
        color[nan_step] = np.nan
    mask = (rng.rand(K, B, R, 1) > 0.3).astype(np.float32)
    return camloc, raydir, color, mask


# a NaN colour reaches the gradients under the L2 colour loss; under L1
# both packages' |x| pass the finite -g on at a NaN difference, so both
# take such a step
L2 = ["train.rgb_loss=l2"]


def _jax_steps(ref, batches, jconf=None):
    p = jax.tree_util.tree_map(jnp.asarray, ref["params"])
    s = jopt.init_optimizer(p)
    p, s, mons = jax_train_steps(
        p, s, *map(jnp.asarray, batches), jnp.float32(CAR), jnp.float32(LVG),
        jnp.float32(LR_W), jnp.float32(LR_F), jnp.int32(0),
        jconf or ref["jconf"], cdfs=ref["cdfs"])
    return _np(p), _np(s), _np(mons)


@pytest.fixture(scope="module")
def ref():
    jconf = jax_load_config("tiny_test")
    params = _np(jax.jit(lambda k: jax_init_model(k, jconf))(
        jax.random.PRNGKey(0)))
    cdfs = _np(jax.jit(lambda: jax_make_mc_cdfs(jconf, B, R))())
    out = dict(jconf=jconf, conf=load_config("tiny_test"), params=params,
               cdfs=cdfs)
    out["steps"] = _jax_steps(out, _batches())
    out["jconf_l2"] = jax_load_config("tiny_test", overrides=L2)
    out["conf_l2"] = load_config("tiny_test", overrides=L2)
    out["nan_steps"] = _jax_steps(out, _batches(nan_step=1), out["jconf_l2"])
    return out


def _torch_cdfs(cdfs):
    return {k: [torch.from_numpy(u) for u in v] if isinstance(v, list)
            else torch.from_numpy(v) for k, v in cdfs.items()}


def _port(ref):
    params = params_from_numpy(ref["params"], device="cpu")
    return params, init_optimizer(params), _torch_cdfs(ref["cdfs"])


def _port_steps(ref, batches, sched=(CAR, LVG, LR_W, LR_F), conf=None):
    params, state, cdfs = _port(ref)
    mons = train_steps(params, state, *map(torch.from_numpy, batches),
                       *sched, 0, conf or ref["conf"], cdfs=cdfs)
    return params, state, mons


def _assert_state_equal(a, b):
    for (path, x), (_, y) in zip(tree_leaves_with_path(a),
                                 tree_leaves_with_path(b)):
        assert torch.equal(x, y), path


def _close_to_jax(params, state, jp, js):
    """The port's state after K steps against the JAX package's, to the
    tolerances of test_torch_slice.py::test_two_train_steps_match: each
    parameter within 2 lr per step (an Adam step moves an entry by ~lr *
    sign(g), and where |g| is at f32 noise the sign may differ), all but
    5e-4 of the entries per step (that test's 1e-3 over its two steps)
    within 1e-2 lr.  Each moment leaf within 2e-2 of its largest entry:
    the first step's gradients agree to 1e-3 of each leaf's largest, the
    later ones are taken at parameters that already differ by up to 2 lr
    (at most 1.06e-2 here, soft-visibility's first bias on the CPU)."""
    got = params_to_numpy(params)
    moved, n = 0, 0
    for path, w in tree_leaves_with_path(jp):
        diff = np.abs(_leaf(got, path) - w)
        assert diff.max() <= 2 * K * LR_F, path
        moved += int(np.sum(diff > 1e-2 * LR_W))
        n += w.size
    assert moved <= 5e-4 * K * n, (moved, n)
    for name in ("mu", "nu"):
        mine = params_to_numpy(state[name])
        for path, w in tree_leaves_with_path(getattr(js.adam, name)):
            scale = np.abs(w).max()
            assert np.abs(_leaf(mine, path) - w).max() \
                <= 2e-2 * scale + 1e-12, (name, path)


def test_train_steps_matches_jax(ref):
    params, state, mons = _port_steps(ref, _batches())
    jp, js, jmons = ref["steps"]
    assert int(state["count"]) == int(js.adam.count) == K
    assert state["count"].dtype == torch.int32
    assert set(mons) == set(jmons)
    for k, v in jmons.items():
        assert mons[k].shape == (K,), k
        if k == "grads_finite":
            assert mons[k].tolist() == v.tolist() == [True] * K
            continue
        # as test_torch_slice.py holds them: the first step's monitors
        # to f32 reassociation over the batch's reductions, and after
        # updates the loss (a term alone moves further with the parameters
        # that differ by a step)
        np.testing.assert_allclose(mons[k][0].item(), v[0], rtol=1e-4,
                                   atol=1e-8, err_msg=k)
    np.testing.assert_allclose(mons["loss"].numpy(), jmons["loss"],
                               rtol=1e-4)
    _close_to_jax(params, state, jp, js)


def test_train_steps_equals_k_train_step_calls_bitwise(ref):
    batches = _batches()
    params, state, mons = _port_steps(ref, batches)
    p2, s2, cdfs = _port(ref)
    seq = [train_step(p2, s2, *(torch.from_numpy(a[j]) for a in batches),
                      CAR, LVG, LR_W, LR_F, ref["conf"], cdfs=cdfs, step=j)
           for j in range(K)]
    _assert_state_equal(params, p2)
    _assert_state_equal(state["mu"], s2["mu"])
    _assert_state_equal(state["nu"], s2["nu"])
    assert torch.equal(state["count"], s2["count"])
    for k in mons:
        assert torch.equal(mons[k], torch.stack([m[k] for m in seq])), k


def test_non_finite_middle_step_is_skipped_in_both(ref):
    """A NaN colour in batch 1 (L2 colour loss): both packages skip that
    step alone (the state after the three steps is, bitwise, that after
    batches 0 and 2 alone), and the steps around it still match."""
    batches = _batches(nan_step=1)
    conf = ref["conf_l2"]
    params, state, mons = _port_steps(ref, batches, conf=conf)
    jp, js, jmons = ref["nan_steps"]
    assert mons["grads_finite"].tolist() == jmons["grads_finite"].tolist() \
        == [True, False, True]
    assert int(state["count"]) == int(js.adam.count) == 2
    assert np.isnan(mons["loss"][1].item()) and np.isnan(jmons["loss"][1])
    _close_to_jax(params, state, jp, js)

    two = [np.ascontiguousarray(a[[0, 2]]) for a in batches]
    p2, s2, _ = _port_steps(ref, two, conf=conf)
    _assert_state_equal(params, p2)
    _assert_state_equal(state["mu"], s2["mu"])
    _assert_state_equal(state["nu"], s2["nu"])
    assert torch.equal(state["count"], s2["count"])
    jp2, js2, _ = _jax_steps(ref, two, ref["jconf_l2"])
    for a, b in zip(jax.tree_util.tree_leaves((jp, js)),
                    jax.tree_util.tree_leaves((jp2, js2))):
        np.testing.assert_array_equal(a, b)

    # the skipped step alone: the flag a device bool, nothing moved, a
    # -0.0 parameter and moment included
    p, s, cdfs = _port(ref)
    train_step(p, s, *(torch.from_numpy(a[0]) for a in batches), CAR, LVG,
               LR_W, LR_F, conf, cdfs=cdfs)
    for tree in (p, s["mu"]):
        next(v for _, v in tree_leaves_with_path(tree)).view(-1)[:2] = -0.0
    before = [{k: v.clone() for k, v in tree_leaves_with_path(t)}
              for t in (p, s["mu"], s["nu"])]
    count = s["count"].clone()
    m = train_step(p, s, *(torch.from_numpy(a[1]) for a in batches), CAR,
                   LVG, LR_W, LR_F, conf, cdfs=cdfs)
    assert m["grads_finite"].dtype == torch.bool and not m["grads_finite"]
    for tree, old in zip((p, s["mu"], s["nu"]), before):
        for path, v in tree_leaves_with_path(tree):
            assert torch.equal(v, old[path]), path
    assert torch.equal(s["count"], count) and int(count) == 1


def _trainer(tmp_path, spc):
    conf = load_config("tiny_test", overrides=[
        "valid.skip=true", "data_path=synthetic/sphere", "train.epoch=3",
        "train.n_rays=16", "train.checkpoint_interval_epochs=0",
        "train.warmup_term_ratio=0", f"train.steps_per_call={spc}",
        "renderer.proposal_method=coarse_grid",
        "renderer.proposal_grid_size=16",
        f"monitor_base_path={tmp_path}/spc{spc}"])
    images, masks, cameras = render_sphere_scene(n_views=12, H=16, W=16)
    ds = IDRDataset(conf, images, masks, cameras, train=True, shuffle=True)
    return Trainer(conf, dataset=ds, device="cpu", seed=0)


def test_trainer_steps_per_call_4_equals_1_bitwise(tmp_path):
    """Six steps an epoch (calls of 4 and 2) with the coarse-grid proposal
    (refreshed at steps 0 and 16 either way): the same history and
    parameters as one step a call, bitwise."""
    one, four = _trainer(tmp_path, 1), _trainer(tmp_path, 4)
    assert one.ds.iters_per_epoch == 6
    init = {k: v.clone() for k, v in tree_leaves_with_path(one.params)}
    one.train()
    four.train()
    assert len(one.history) == len(four.history) == 18
    assert one.history == four.history
    assert all(m["grads_finite"] for m in one.history)
    _assert_state_equal(one.params, four.params)
    _assert_state_equal(one.opt_state["mu"], four.opt_state["mu"])
    assert torch.equal(one.opt_state["count"], four.opt_state["count"])
    assert int(four.opt_state["count"]) == 18
    assert any(not torch.equal(v, init[k])
               for k, v in tree_leaves_with_path(four.params))


def test_bias_correction_matches_jax_in_f32():
    """sqrt(1 - b2^t) / (1 - b1^t) in f32 at t = 1 ... 10^4 against the
    JAX package's expression (ndjir_tpu/train/optim.py:90-91).  Both take
    f32 powers, whose last bit may differ between the libraries; near
    t = 1 the 1 - b2^t cancellation turns one ulp of b2^t (6e-8) into
    6e-5 of the result, so the bound is 2 ulps of b^t carried through
    the subtraction: |d| <= 2 * 2^-24 * (b1^t/(1-b1^t) + b2^t/(1-b2^t)/2)
    relative, the larger of the two terms as computed in f64."""
    t = np.arange(1, 10001)
    count = torch.from_numpy((t - 1).astype(np.int32))
    got = bias_correction(count).numpy()
    tf = jnp.asarray(t, jnp.float32)
    want = np.asarray(jax.jit(lambda x: jnp.sqrt(1.0 - jopt._B2 ** x)
                              / (1.0 - jopt._B1 ** x))(tf))
    assert got.dtype == want.dtype == np.float32
    b1t, b2t = jopt._B1 ** t.astype(np.float64), \
        jopt._B2 ** t.astype(np.float64)
    bound = 2 * 2.0 ** -24 * (b1t / (1 - b1t) + 0.5 * b2t / (1 - b2t)) \
        + 4 * 2.0 ** -24
    rel = np.abs(got.astype(np.float64) - want) / np.abs(want)
    assert np.all(rel <= bound), (rel.max(), t[np.argmax(rel / bound)])


def test_schedule_scalars_as_tensors_equal_floats_bitwise(ref):
    """The trainer hands the step its schedule as 0-dim f32 tensors; a
    caller may pass floats: the same step, bitwise."""
    batches = _batches()
    as_floats = _port_steps(ref, batches)
    as_tensors = _port_steps(ref, batches, sched=[
        torch.tensor(v, dtype=torch.float32) for v in (CAR, LVG, LR_W, LR_F)])
    _assert_state_equal(as_floats[0], as_tensors[0])
    _assert_state_equal(as_floats[1]["nu"], as_tensors[1]["nu"])
    for k in as_floats[2]:
        assert torch.equal(as_floats[2][k], as_tensors[2][k]), k


@pytest.mark.parametrize("zeros", [False, True])
def test_exclusive_cumprod_backward_matches_torch(zeros):
    """The transmittance's exclusive cumprod (``render/sampler.py``), whose
    backward takes no host read: its forward is torch.cumprod's bitwise,
    its gradient torch's to f64 rounding, with zeros in the input too
    (alpha = 1), and it is twice differentiable."""
    from ndjir_torch.render.sampler import (
        _exclusive_cumprod,
        _exclusive_cumprod_plain,
    )
    gen = torch.Generator().manual_seed(3)
    x = torch.rand(3, 5, 37, 1, dtype=torch.float64, generator=gen)
    if zeros:
        x[0, 1, 5] = x[1, 2, 5] = x[1, 2, 20] = x[2, 0, 36] = x[2, 1, 0] = 0
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = _exclusive_cumprod(a, 2), _exclusive_cumprod_plain(b, 2)
    assert torch.equal(ya, yb)
    g = torch.randn(ya.shape, dtype=torch.float64, generator=gen)
    (ga,) = torch.autograd.grad(ya, a, g)
    (gb,) = torch.autograd.grad(yb, b, g)
    torch.testing.assert_close(ga, gb, rtol=0, atol=1e-14)
    small = a[:1, :2, :7].detach().requires_grad_()
    assert torch.autograd.gradgradcheck(
        lambda t: _exclusive_cumprod(t, 2), (small,))
