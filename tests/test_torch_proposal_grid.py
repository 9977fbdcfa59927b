"""The port's coarse-grid proposal against the JAX package's (CPU; mirrors
``tests/test_proposal_grid.py``).

``tiny_test`` widths with a G_c=16 snapshot.  Both sides start from the
JAX ``init_model`` parameters (bridged) and take the same uniforms, as
numpy.  Tolerances: the snapshot at rtol 1e-5, atol 1e-6 (the geometric
MLP in float32, summed in another order); sample positions t within 1e-5
of the JAX package's (the same sections and inverse CDF, float32 rounding
of the trilinear reads).  The trainers are held to refresh the snapshot at
the same global steps, with ``steps_per_call`` 1 and beyond the refresh
interval.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ndjir_tpu.train.trainer as jtrainer
from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.models.fields import init_model as jax_init_model
from ndjir_tpu.render.renderer import make_mc_cdfs as jax_make_mc_cdfs
from ndjir_tpu.render.sampler import make_proposal_grid as jax_make_grid
from ndjir_tpu.render.sampler import sample_points as jax_sample_points

import ndjir_torch.train.trainer as ttrainer
from ndjir_torch.bridge import params_from_numpy
from ndjir_torch.config import load_config
from ndjir_torch.data.synthetic import make_synthetic_scene
from ndjir_torch.render.sampler import make_proposal_grid, sample_points

torch.set_num_threads(2)

CG = ["renderer.proposal_method=coarse_grid",
      "renderer.proposal_grid_size=16"]
B, R = 2, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    jconf = jax_load_config("tiny_test", overrides=CG)
    params = _np(jax_init_model(jax.random.PRNGKey(0), jconf))
    rng = np.random.RandomState(7)
    camloc = np.tile(np.float32([[0.0, 0.1, 2.5]]), (B, 1))
    raydir = rng.randn(B, R, 3).astype(np.float32) * 0.3
    raydir[..., 2] -= 1.0
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    cdfs = _np(jax.jit(lambda: jax_make_mc_cdfs(jconf, B, R))())
    grid = np.asarray(jax_make_grid(params, jconf))
    return dict(jconf=jconf, params=params, camloc=camloc, raydir=raydir,
                cdfs=cdfs, grid=grid)


def _torch(ref):
    conf = load_config("tiny_test", overrides=CG)
    params = params_from_numpy(ref["params"], device="cpu")
    cd = ref["cdfs"]
    return conf, params, torch.from_numpy(ref["camloc"]), \
        torch.from_numpy(ref["raydir"]), torch.from_numpy(cd["stratified"]), \
        torch.from_numpy(cd["background"]), \
        [torch.from_numpy(u) for u in cd["upsample"]]


def test_snapshot_matches_jax(ref):
    conf, params, *_ = _torch(ref)
    grid = make_proposal_grid(params, conf)
    assert grid.shape == (16, 16, 16, 1) and not grid.requires_grad
    np.testing.assert_allclose(grid.numpy(), ref["grid"], rtol=1e-5,
                               atol=1e-6)


def test_snapshot_builds_in_chunks(ref, monkeypatch):
    """A snapshot built a few points per network call equals one built in
    one call."""
    import ndjir_torch.render.sampler as sampler

    conf, params, *_ = _torch(ref)
    whole = make_proposal_grid(params, conf)
    monkeypatch.setattr(sampler, "_SNAPSHOT_CHUNK", 1000)
    np.testing.assert_array_equal(make_proposal_grid(params, conf).numpy(),
                                  whole.numpy())


@pytest.mark.parametrize("own_grid", [False, True],
                         ids=["jax_snapshot", "own_snapshot"])
def test_coarse_grid_samples_match_jax(ref, own_grid):
    """Samples from the coarse grid against the JAX package's, handed the
    same uniforms and the JAX snapshot or the port's own: t within 1e-5,
    sorted, inside [t_near, t_far] where the ray hits."""
    conf, params, camloc, raydir, strat, bg, ups = _torch(ref)
    grid = make_proposal_grid(params, conf) if own_grid \
        else torch.from_numpy(ref["grid"])
    x, t, xb, tb, mask = sample_points(params, camloc, raydir, strat, bg,
                                       conf, rand_u=ups, proposal_grid=grid)
    cd = ref["cdfs"]
    jx, jt, jxb, jtb, jmask = _np(jax_sample_points(
        ref["params"], ref["camloc"], ref["raydir"], cd["stratified"],
        cd["background"], ref["jconf"], rand_u=cd["upsample"],
        proposal_grid=jnp.asarray(ref["grid"])))
    np.testing.assert_array_equal(mask.numpy(), jmask)
    np.testing.assert_allclose(t.numpy(), jt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), jtb, rtol=1e-6)
    tt = t.numpy()[..., 0]
    assert np.all(np.diff(tt, axis=2) >= 0)
    hit = mask.numpy()[..., 0, 0] > 0
    near, far = tt[..., 0], tt[..., -1]
    assert np.all(near[hit] <= far[hit])
    assert np.all(np.isfinite(x.numpy()))


def test_none_grid_falls_back_to_network(ref):
    """With no snapshot the coarse-grid config proposes with the network,
    exactly as the network-proposal config does."""
    conf, params, camloc, raydir, strat, bg, ups = _torch(ref)
    net = load_config("tiny_test")
    a = sample_points(params, camloc, raydir, strat, bg, net, rand_u=ups)
    b = sample_points(params, camloc, raydir, strat, bg, conf, rand_u=ups,
                      proposal_grid=None)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    c = sample_points(params, camloc, raydir, strat, bg, conf, rand_u=ups,
                      proposal_grid=make_proposal_grid(params, conf))
    assert not torch.equal(a[1], c[1])


# 3 epochs of 5 steps at refresh interval 4, by steps_per_call: 1 refreshes
# at every multiple of the interval; 3 only where a call (starting at
# steps 0, 3, 5, 8, 10, 13) lands on one; 8 is capped at 4 (calls at 0, 4,
# 5, 9, 10, 14)
REFRESHES = {1: [0, 4, 8, 12], 3: [0, 8], 8: [0, 4]}


@pytest.mark.parametrize("spc", sorted(REFRESHES))
def test_trainer_refreshes_where_jax_does(tmp_path, monkeypatch, spc):
    """Both trainers over 3 epochs of 5 steps at refresh interval 4: the
    global steps whose parameters the snapshot is rebuilt from.  The
    steps themselves are stubbed on both sides (the schedule is the
    trainers' loops, not their arithmetic)."""
    scene = make_synthetic_scene(str(tmp_path / "scene"), n_views=10,
                                 H=16, W=16)
    over = CG + ["renderer.proposal_refresh_interval=4", "train.epoch=3",
                 f"train.steps_per_call={spc}", "valid.skip=true",
                 "train.checkpoint_interval_epochs=0", f"data_path={scene}"]
    mons = ("loss", "loss_rgb", "loss_eikonal", "loss_tv", "loss_mask",
            "prior_base_color", "prior_roughness",
            "prior_specular_reflectance", "reg_std_roughness",
            "reg_std_specular_reflectance", "gain")

    jevents = []

    def jstep(params, opt_state, *a, **k):
        jevents.append(("step", int(a[8])))
        return params, opt_state, {**{m: np.float32(0) for m in mons},
                                   "grads_finite": np.bool_(True)}

    def jsteps(params, opt_state, camloc, *a, **k):
        n = camloc.shape[0]
        jevents.extend(("step", int(a[7]) + j) for j in range(n))
        return params, opt_state, {**{m: np.zeros(n, np.float32)
                                      for m in mons},
                                   "grads_finite": np.ones(n, bool)}

    monkeypatch.setattr(jtrainer, "train_step", jstep)
    monkeypatch.setattr(jtrainer, "train_steps", jsteps)
    jt = jtrainer.Trainer(jax_load_config("tiny_test", overrides=over + [
        f"monitor_base_path={tmp_path}/jax"]))
    jt._proposal_refresh = lambda p: jevents.append(("refresh",))
    jt.train()

    events = []

    def step(*a, step=None, proposal_grid=None, **k):
        events.append(("step", step))
        return {**{m: torch.tensor(0.0) for m in mons},
                "grads_finite": torch.tensor(True)}

    monkeypatch.setattr(ttrainer, "train_step", step)
    monkeypatch.setattr(ttrainer, "make_proposal_grid",
                        lambda p, c: events.append(("refresh",)))
    tt = ttrainer.Trainer(load_config("tiny_test", overrides=over + [
        f"monitor_base_path={tmp_path}/torch"]), device="cpu")
    tt.train()

    def refresh_steps(ev):
        return [ev[i + 1][1] for i, e in enumerate(ev) if e == ("refresh",)]

    assert [e for e in events if e[0] == "step"] \
        == [e for e in jevents if e[0] == "step"] \
        == [("step", g) for g in range(15)]
    assert refresh_steps(events) == refresh_steps(jevents) \
        == REFRESHES[spc]
