"""The port's production-precision training step against the JAX reference
(CPU).

The reference's production precision (``bench.py:202-205``) is the default
architecture with a bf16 G=256 grid and bf16 MLP operands.  At the size of
tests/test_torch_slice.py (G=48, B=2, R=4) a bf16 table takes the octa
layout and the fused perturbed query on both sides by itself.  Two runs:

(a) ``grid_dtype=bfloat16``, f32 MLP: isolates the octa path and the fold's
    plain version; held at the f32 slice's tolerances, except the bf16
    table's own gradient (its f32 sums are rounded once to bf16).
(b) both bf16: the slice's precision.

Both sides start from the JAX ``init_model`` parameters, handed over as
float32 numpy (exact for the bf16 table) and cast by ``ndjir_torch.bridge``
to the dtypes the port's ``init_model`` gives them, and from the JAX
``make_mc_cdfs`` uniforms.  Each reference function is jitted through a
closure made here, as in tests/test_torch_slice.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ndjir_tpu.ops.grid as jgrid
from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.models.fields import affine_apply as jax_affine_apply
from ndjir_tpu.models.fields import affine_apply_split as jax_affine_split
from ndjir_tpu.models.fields import init_model as jax_init_model
from ndjir_tpu.render.loss import total_loss as jax_total_loss
from ndjir_tpu.render.renderer import make_mc_cdfs as jax_make_mc_cdfs
from ndjir_tpu.render.sampler import sample_points as jax_sample_points
from ndjir_tpu.train.optim import apply_updates as jax_apply_updates
from ndjir_tpu.train.optim import init_optimizer as jax_init_optimizer

from ndjir_torch.bridge import params_from_numpy, params_to_numpy
from ndjir_torch.config import load_config
from ndjir_torch.models.fields import (
    affine_apply,
    affine_apply_split,
    geometric_supports_shared_gather,
    init_model,
)
from ndjir_torch.render.loss import total_loss
from ndjir_torch.render.sampler import sample_points
from ndjir_torch.train.optim import apply_updates, init_optimizer
from ndjir_torch.train.optim import tree_leaves_with_path
from ndjir_torch.train.trainer import train_step

torch.set_num_threads(2)

B, R = 2, 4
G48 = ["geometric_network.voxel.grid_size=48"]
RUNS = {"a": G48 + ["precision.grid_dtype=bfloat16"],
        "b": G48 + ["precision.grid_dtype=bfloat16",
                    "precision.mlp_dtype=bfloat16"]}
PROPOSAL_BF16 = G48 + ["renderer.proposal_grid_bf16=true"]
CAR, LVG = 0.37, 0.9          # mid-schedule cos-anneal ratio and lv gain
LR_W, LR_F = 1e-3, 2e-3       # distinct, so the feature/weight split shows
GRID = ("geometric-network", "grid", "F")


def _np(tree):
    """A reference tree as numpy, bf16 leaves as (exact) float32."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _bf16_ulp(a):
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _batch():
    rng = np.random.RandomState(7)
    camloc = np.tile(np.asarray([[0.1, -0.2, 2.5]], np.float32), (B, 1))
    raydir = rng.randn(B, R, 3).astype(np.float32) \
        - np.asarray([0.0, 0.0, 3.0], np.float32)
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    color = rng.rand(B, R, 3).astype(np.float32)
    obj_mask = np.ones((B, R, 1), np.float32)
    return camloc, raydir, color, obj_mask


def _samples(jconf, params, batch, cdfs):
    return _np(jax.jit(lambda p: jax_sample_points(
        p, *map(jnp.asarray, batch[:2]), cdfs["stratified"],
        cdfs["background"], jconf, rand_u=cdfs["upsample"]))(params))


@pytest.fixture(scope="module")
def ref():
    """Per run: the reference's parameters (as JAX arrays and as numpy),
    loss, monitors and gradients; for run (b) also its samples and two
    train steps; and the samples of an f32 table under
    ``proposal_grid_bf16``."""
    batch = _batch()
    out = {"batch": batch}
    for run, overrides in RUNS.items():
        jconf = jax_load_config("default", overrides=overrides)
        jparams = jax.jit(lambda k: jax_init_model(k, jconf))(
            jax.random.PRNGKey(0))
        F = jparams["geometric-network"]["grid"]["F"]
        assert F.dtype == jnp.bfloat16
        assert jgrid.use_octa_layout(F.shape, F.dtype)
        cdfs = _np(jax.jit(lambda: jax_make_mc_cdfs(jconf, B, R))())

        def lossfn(pp):
            return jax_total_loss(pp, *map(jnp.asarray, batch),
                                  jnp.float32(CAR), jnp.float32(LVG), jconf,
                                  cdfs=cdfs)
        vg = jax.jit(jax.value_and_grad(lossfn, has_aux=True))

        def value_and_grad(p):
            (loss, mons), g = vg(p)
            return float(loss), {k: float(v) for k, v in mons.items()}, g
        r = dict(conf=load_config("default", overrides=overrides),
                 params=_np(jparams), raw_params=jax.tree_util.tree_map(
                     np.asarray, jparams), cdfs=cdfs)
        loss, mons, g = value_and_grad(jparams)
        r["value_and_grad"] = (loss, mons, _np(g))
        if run == "b":
            r["samples"] = _samples(jconf, jparams, batch, cdfs)
            update = jax.jit(lambda p, g, s: jax_apply_updates(
                p, g, s, jnp.float32(LR_W), jnp.float32(LR_F), jconf))
            p, s = jparams, jax_init_optimizer(jparams)
            for step in range(2):
                p, s, finite = update(p, g, s)
                assert bool(finite)
                if step == 0:
                    r["after_one_update"] = _np(p)
                    r["grads"] = g
                    _, r["step2_monitors"], g = value_and_grad(p)
            r["after_two_steps"] = _np(p)
        out[run] = r

    jconf = jax_load_config("default", overrides=PROPOSAL_BF16)
    jparams = jax.jit(lambda k: jax_init_model(k, jconf))(
        jax.random.PRNGKey(0))
    assert jparams["geometric-network"]["grid"]["F"].dtype == jnp.float32
    cdfs = _np(jax.jit(lambda: jax_make_mc_cdfs(jconf, B, R))())
    out["proposal"] = dict(conf=load_config("default",
                                            overrides=PROPOSAL_BF16),
                           params=_np(jparams), cdfs=cdfs,
                           samples=_samples(jconf, jparams, batch, cdfs))
    return out


def _torch_inputs(ref, run):
    r = ref[run]
    params = params_from_numpy(r["params"], device="cpu", conf=r["conf"])
    batch = [torch.from_numpy(a) for a in ref["batch"]]
    cdfs = {k: [torch.from_numpy(u) for u in v] if isinstance(v, list)
            else torch.from_numpy(v) for k, v in r["cdfs"].items()}
    return params, batch, cdfs


def _torch_value_and_grad(ref, run):
    params, batch, cdfs = _torch_inputs(ref, run)
    leaves = list(tree_leaves_with_path(params))
    for _, p in leaves:
        p.requires_grad_(True)
    loss, mons = total_loss(params, *batch, CAR, LVG, ref[run]["conf"],
                            cdfs=cdfs)
    grads = torch.autograd.grad(loss, [p for _, p in leaves],
                                allow_unused=True)
    return loss.detach(), mons, leaves, grads


# ---------------------------------------------------------------------------
# config, bridge, affine layers, optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overrides", [[], ["precision.grid_dtype=bfloat16",
                                            "geometric_network.voxel."
                                            "grid_size=256"]])
def test_bf16_config_is_the_reference_preset(overrides):
    got = load_config("bf16", overrides=overrides).to_dict()
    assert got == jax_load_config("bf16", overrides=overrides).to_dict()
    assert got["precision"]["mlp_dtype"] == "bfloat16"


def test_bridge_carries_bf16_leaves_bitwise(ref):
    r = ref["a"]
    params = params_from_numpy(r["params"], device="cpu", conf=r["conf"])
    assert _leaf(params, GRID).dtype == torch.bfloat16
    assert _leaf(params, ("geometric-network", "affine-00", "W")).dtype \
        == torch.float32
    # the raw reference leaves (ml_dtypes bfloat16 for the table) give the
    # same tensors
    raw = params_from_numpy(r["raw_params"], device="cpu")
    for path, t in tree_leaves_with_path(params):
        assert torch.equal(_leaf(raw, path), t), path
    # and back: float32 numpy, bitwise the reference's values
    back = params_to_numpy(params)
    for path, w in tree_leaves_with_path(r["params"]):
        assert _leaf(back, path).dtype == np.float32
        np.testing.assert_array_equal(_leaf(back, path), w)
    # the port's own init gives the table the same dtype
    assert _leaf(init_model(r["conf"], device="cpu"), GRID).dtype \
        == torch.bfloat16


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_affine_bf16_matches_the_reference(out_dtype):
    rng = np.random.RandomState(4)
    p = {"W": rng.randn(300, 256).astype(np.float32) / 10,
         "b": rng.randn(256).astype(np.float32)}
    h = rng.randn(2, 50, 300).astype(np.float32)
    parts = [h[..., :3], h[:, :1, 3:140], h[..., 140:]]
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jd, td = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    cases = [
        (jax_affine_apply(jp, jnp.asarray(h), jnp.bfloat16, out_dtype=jd),
         affine_apply(tp, torch.from_numpy(h), torch.bfloat16,
                      out_dtype=td)),
        (jax_affine_split(jp, [jnp.asarray(t) for t in parts], jnp.bfloat16,
                          out_dtype=jd),
         affine_apply_split(tp, [torch.from_numpy(t) for t in parts],
                            torch.bfloat16, out_dtype=td)),
    ]
    # exact products of the bf16-rounded operands, summed in float64
    hb = np.asarray(jnp.asarray(h).astype(jnp.bfloat16).astype(jnp.float32))
    Wb = np.asarray(jnp.asarray(p["W"]).astype(jnp.bfloat16)
                    .astype(jnp.float32))
    exact = hb.astype(np.float64) @ Wb.astype(np.float64) + p["b"]
    for want, got in cases:
        assert got.dtype == td and got.shape == want.shape
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        # f32 sums of the same products in another order, rounded once:
        # within one bf16 ulp of each output, and of f32 rounding (1e-6
        # of the largest) where a sum cancels to near zero
        tol = _bf16_ulp(want) + 1e-6 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= tol), out_dtype
    if out_dtype == "float32":
        # f32 accumulation: nowhere near bf16's 2^-8, which a bf16 matmul
        # rounded before the bias add would show
        got = cases[0][1].numpy()
        assert np.abs(got - exact).max() <= 1e-5 * np.abs(exact).max()


@pytest.mark.parametrize("clip", [0.0, 20.0])
def test_apply_updates_on_a_bf16_table_rounds_once(ref, clip):
    """One optimizer step from the reference's gradients: f32 moments, the
    update computed in f32 and rounded once into the bf16 table; with a
    gradient clip (20 against a norm of ~43, so it binds), the clipped bf16
    gradient is f32."""
    r = ref["b"]
    want_tree = r["after_one_update"]
    conf = r["conf"]
    if clip:
        overrides = RUNS["b"] + [f"train.clip_grad_norm={clip}"]
        jconf = jax_load_config("default", overrides=overrides)
        jparams = jax.tree_util.tree_map(jnp.asarray, r["raw_params"])
        want_tree = _np(jax.jit(lambda p, g, s: jax_apply_updates(
            p, g, s, jnp.float32(LR_W), jnp.float32(LR_F), jconf))(
                jparams, r["grads"], jax_init_optimizer(jparams))[0])
        conf = load_config("default", overrides=overrides)
    params = params_from_numpy(r["params"], device="cpu", conf=conf)
    grads = params_from_numpy(_np(r["grads"]), device="cpu", conf=conf)
    state = init_optimizer(params)
    assert apply_updates(params, grads, state, LR_W, LR_F, conf)
    assert _leaf(state["mu"], GRID).dtype == torch.float32
    assert _leaf(state["nu"], GRID).dtype == torch.float32
    table = _leaf(params, GRID)
    assert table.dtype == torch.bfloat16
    got = table.float().numpy()
    want = _leaf(want_tree, GRID)
    same = np.mean(got == want)
    # measured without the clip: 99.997% bitwise equal (the parent's
    # rounding of the step to bf16 before the subtraction: 51.6%).  The
    # clip's scale, a norm summed in another order, differs by an f32 ulp;
    # where the decayed gradient is near Adam's eps the step nearly cancels
    # the entry, and a rounding of a near-zero result moves: 99.2% equal,
    # the rest within one ulp plus an f32 rounding of the step
    assert same >= (0.99 if clip else 0.999), same
    assert np.all(np.abs(got - want) <= _bf16_ulp(want) + (1e-9 if clip
                                                            else 0.0))
    got = params_to_numpy(params)
    for path, w in tree_leaves_with_path(want_tree):
        if path != GRID:
            np.testing.assert_allclose(_leaf(got, path), w, rtol=1e-6,
                                       atol=1e-5 * LR_F, err_msg=str(path))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def test_the_bf16_table_takes_the_octa_fused_path(ref):
    for run in RUNS:
        params, _, _ = _torch_inputs(ref, run)
        assert geometric_supports_shared_gather(params["geometric-network"],
                                                ref[run]["conf"])


# (loss rtol, monitor rtol, monitor atol, gradient tolerance per leaf as a
# share of its largest entry).  Measured worst: (a) loss 2.5e-7, monitors
# 2.1e-6, gradients 1.4e-5, the bf16 table's within one ulp everywhere;
# (b) loss 7.6e-4, monitors 2.9e-3 (loss_tv), gradients 4.4e-2 (the
# table's).  Run (b)'s gap is bf16 rounding at other places: the port's
# fused softplus rounds once where the reference's stable form rounds
# after each of its bf16 ops, and the eight layers compound it.
TOL = {"a": (1e-5, 1e-4, 1e-8, 1e-3), "b": (2e-3, 1e-2, 1e-6, 5e-2)}


@pytest.mark.parametrize("run", ["a", "b"])
def test_total_loss_and_monitors_match(ref, run):
    loss, mons, _, _ = _torch_value_and_grad(ref, run)
    want_loss, want_mons, _ = ref[run]["value_and_grad"]
    loss_rtol, mon_rtol, mon_atol, _ = TOL[run]
    np.testing.assert_allclose(float(loss), want_loss, rtol=loss_rtol)
    assert set(mons) == set(want_mons)
    for k, v in want_mons.items():
        np.testing.assert_allclose(float(mons[k]), v, rtol=mon_rtol,
                                   atol=mon_atol, err_msg=k)


@pytest.mark.parametrize("run", ["a", "b"])
def test_every_param_grad_matches(ref, run):
    _, _, leaves, grads = _torch_value_and_grad(ref, run)
    want = ref[run]["value_and_grad"][2]
    tol = TOL[run][3]
    assert len(leaves) == len(jax.tree_util.tree_leaves(want))
    for (path, p), g in zip(leaves, grads):
        w = _leaf(want, path)
        assert g is not None and g.dtype == p.dtype, path
        g = g.float().numpy()
        scale = np.abs(w).max()
        if path == GRID and run == "a":
            # f32 sums rounded once to bf16: a sum taken in another order
            # may round to the neighbouring value
            assert np.all(np.abs(g - w) <= _bf16_ulp(w) + tol * scale)
        else:
            assert np.abs(g - w).max() <= tol * scale + 1e-12, path


def test_sample_points_match_bf16(ref):
    params, batch, cdfs = _torch_inputs(ref, "b")
    got = sample_points(params, *batch[:2], cdfs["stratified"],
                        cdfs["background"], ref["b"]["conf"],
                        rand_u=cdfs["upsample"])
    # two stratified jittered samples lie at most two steps apart
    t_fg = ref["b"]["samples"][1]
    section = 2 * np.max(t_fg[:, :, -1] - t_fg[:, :, 0]) \
        / ref["b"]["conf"].renderer.n_samples0
    for name, g, want in zip(["x_fg", "t_fg", "x_bg", "t_bg", "mask"], got,
                             ref["b"]["samples"]):
        assert g.shape == want.shape, name
        diff = np.abs(g.numpy() - want)
        # the proposal SDFs differ at bf16 resolution: the port's fused
        # softplus rounds once where the reference's stable form rounds
        # after each of its bf16 ops, and the importance sampler (gains up
        # to 512) moves a sample between its stratified neighbours.  The
        # bulk agrees to f32 rounding (measured: 80% within 2.4e-7, the
        # largest move 0.043 against a bound of 0.064)
        assert np.quantile(diff, 0.8) < 1e-4, name
        assert diff.max() < section, name
    np.testing.assert_array_equal(got[4].numpy(), ref["b"]["samples"][4])


def test_proposal_grid_bf16_samples_match(ref):
    r = ref["proposal"]
    params = params_from_numpy(r["params"], device="cpu", conf=r["conf"])
    assert _leaf(params, GRID).dtype == torch.float32
    batch = [torch.from_numpy(a) for a in ref["batch"]]
    cdfs = {k: [torch.from_numpy(u) for u in v] if isinstance(v, list)
            else torch.from_numpy(v) for k, v in r["cdfs"].items()}
    got = sample_points(params, *batch[:2], cdfs["stratified"],
                        cdfs["background"], r["conf"],
                        rand_u=cdfs["upsample"])
    for name, g, want in zip(["x_fg", "t_fg", "x_bg", "t_bg", "mask"], got,
                             r["samples"]):
        diff = np.abs(g.numpy() - want)
        assert np.quantile(diff, 0.99) < 1e-4, name
        assert diff.max() < 0.05, name
    # the table itself is left in f32
    assert _leaf(params, GRID).dtype == torch.float32


def test_two_train_steps_match_bf16(ref):
    params, batch, cdfs = _torch_inputs(ref, "b")
    state = init_optimizer(params)
    mons = [train_step(params, state, *batch, CAR, LVG, LR_W, LR_F,
                       ref["b"]["conf"], cdfs=cdfs) for _ in range(2)]
    assert all(bool(m["grads_finite"]) for m in mons)
    assert state["count"] == 2
    assert _leaf(params, GRID).dtype == torch.bfloat16
    np.testing.assert_allclose(float(mons[1]["loss"]),
                               ref["b"]["step2_monitors"]["loss"], rtol=2e-3)
    got = params_to_numpy(params)
    for path, w in tree_leaves_with_path(ref["b"]["after_two_steps"]):
        # each Adam step moves an entry by ~lr * sign(g); where |g| is at
        # rounding noise the sign may differ: at most 2 lr per step, plus
        # one bf16 ulp of the table's entries
        bound = 4 * LR_F + (_bf16_ulp(w) if path == GRID else 0.0)
        assert np.all(np.abs(_leaf(got, path) - w) <= bound), path
