"""The port's parallel package on the CPU: ray-sharded steps over gloo and
the multi-scene trainer (mirrors ``tests/test_mesh_equivalence.py`` and
``tests/test_multi_scene.py``).

One spawned job of two gloo processes (``tests/torch_parallel_worker.py``,
~20 s) runs the sharded paths once for the whole module; each test holds
a piece of its result against the same work unsharded in this process.
Tolerances: the loss and monitors at rtol 1e-5, each gradient leaf within
1e-5 of its largest entry (float32 sums split across two shards add in
another order); trained parameters as ``tests/test_torch_slice.py`` holds
two implementations' steps: every entry within 2 lr of the other per
update (an Adam step moves an entry by ~lr sign(g), and where |g| is at
float32 noise the sign may differ), at most 1e-3 of the entries beyond
1e-2 lr.  The scene-sharded multi-scene run splits no sum and is held
bitwise.
"""

import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_worker as W

from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.parallel.multi_scene import (
    MultiSceneTrainer as JaxMultiSceneTrainer,
)
from ndjir_tpu.train import checkpoint as jckpt
from ndjir_tpu.train.optim import AdamState, OptState

from ndjir_torch.config import load_config
from ndjir_torch.data.synthetic import make_synthetic_scene
from ndjir_torch.models.fields import init_model
from ndjir_torch.parallel.mesh import ShardingPlan
from ndjir_torch.parallel.multi_scene import (
    MultiSceneTrainer,
    multi_scene_train_step,
)
from ndjir_torch.render.renderer import make_mc_cdfs
from ndjir_torch.train import checkpoint
from ndjir_torch.train.optim import init_optimizer, tree_leaves_with_path
from ndjir_torch.train.trainer import Trainer, loss_and_grads, train_step

torch.set_num_threads(2)

JOB_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Rank 0's results of the two-process gloo job."""
    out = str(tmp_path_factory.mktemp("gloo"))
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=W.run, args=(r, port, out)) for r in (0, 1)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOB_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    assert not alive, f"the gloo job ran over {JOB_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0, 0]
    return torch.load(os.path.join(out, "rank0.pt"), weights_only=False), out


def _close(a, b, scale=1e-5, what=""):
    for (path, x), (_, y) in zip(tree_leaves_with_path(a),
                                 tree_leaves_with_path(b)):
        tol = scale * max(float(y.abs().max()), 1e-30)
        err = float((x.double() - y.double()).abs().max())
        assert err <= tol, (what, path, err, tol)


@pytest.mark.parametrize("case", range(len(W.STEP_CASES)),
                         ids=[f"{m[0]}x{m[1]}-mask{w}"
                              for m, w in W.STEP_CASES])
def test_sharded_step_equals_unsharded(job, case):
    """Loss, every monitor and every gradient leaf of the [1,2] (rays) and
    [2,1] (images) steps equal the [1,1] step; the mean of the shards' own
    losses does not, which is what the global counts are for."""
    res, _ = job
    mesh, w = W.STEP_CASES[case]
    mons, grads, naive = res["steps"][case]
    conf = W.conf_for([1, 1])
    conf.train.mask_weight = w
    B, R = conf.train.batch_size, conf.train.n_rays
    params = init_model(conf, seed=0, device="cpu")
    _, ref_mons, ref_grads = loss_and_grads(
        params, *W.step_inputs(conf), 0.5, 1.0, conf,
        cdfs=make_mc_cdfs(conf, B, R, device="cpu"))
    for k, v in ref_mons.items():
        np.testing.assert_allclose(mons[k].item(), v.item(), rtol=1e-5,
                                   atol=1e-12, err_msg=k)
    _close(grads, ref_grads, what="grad")
    # ten times the tolerance: the test tells that bug apart
    assert abs(naive - ref_mons["loss"].item()) \
        > 1e-4 * abs(ref_mons["loss"].item())


def _params_close(a, b, lr: float, updates: int, what=""):
    diffs = [(path, (x.double() - y.double()).abs())
             for (path, x), (_, y) in zip(tree_leaves_with_path(a),
                                          tree_leaves_with_path(b))]
    for path, d in diffs:
        assert float(d.max()) <= 2 * lr * updates, (what, path)
    moved = sum(int((d > 1e-2 * lr).sum()) for _, d in diffs)
    n = sum(d.numel() for _, d in diffs)
    assert moved <= 1e-3 * n, (what, moved, n)


def _tiny_datasets(conf, n):
    return W.datasets(conf, n)


def test_sharded_trainer_equals_unsharded(job, tmp_path):
    """A [1,2] Trainer with fresh Monte-Carlo uniforms every step (three
    epochs, the third updating every leaf) against the [1,1] one."""
    res, _ = job
    params, history = res["trainer"]
    conf = W.conf_for([1, 1], W.TRAINER_EXTRA, f"{tmp_path}/mon")
    tr = Trainer(conf, dataset=_tiny_datasets(conf, 1)[0], device="cpu",
                 seed=0)
    tr.train(stop_epoch=W.EPOCHS)
    assert len(history) == len(tr.history) == 6
    for m, ref in zip(history, tr.history):
        assert m["grads_finite"]
        np.testing.assert_allclose(m["loss"], ref["loss"], rtol=1e-5)
    _params_close(params, tr.params, max(tr.lr_w_base, tr.lr_f_base),
                  sum(h["grads_finite"] for h in tr.history), "params")


def _multi(conf, base, n=2):
    conf.train.epoch = W.EPOCHS
    conf.monitor_base_path = base
    return MultiSceneTrainer(conf, [f"{base}/s{i}" for i in range(n)],
                             datasets=_tiny_datasets(conf, n), device="cpu")


def _stacked(ckpt_dir, like, S=2):
    from ndjir_torch.parallel.multi_scene import _stack_like
    params = _stack_like(like, S)
    opt = {"count": 0, "mu": _stack_like(like, S), "nu": _stack_like(like, S)}
    return checkpoint.load_checkpoint(checkpoint.latest_checkpoint(ckpt_dir),
                                      params, opt)


@pytest.mark.parametrize("mesh", W.MULTI_SHAPES,
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_multi_scene_sharded_equals_unsharded(job, tmp_path, mesh):
    """The two-process multi-scene run's stacked checkpoint against the
    one-process run's: scenes over ranks ([2,1]) bitwise, rays over ranks
    ([1,2]) to the module's tolerance."""
    res, _ = job
    ref = _multi(W.conf_for([1, 1]), str(tmp_path / "mon"))
    ref.train()
    like = ref.params[0]
    p, o, extra = _stacked(res["multi"][tuple(mesh)], like)
    rp, ro, rextra = _stacked(ref.ckpt_dir, like)
    assert extra["step"] == rextra["step"] == W.EPOCHS - 1
    assert o["count"] == ro["count"] == [6, 6]
    if mesh == [2, 1]:
        _close(p, rp, 0.0, "params")
        _close(o["mu"], ro["mu"], 0.0, "mu")
    else:
        _params_close(p, rp, max(ref.lr_w_base, ref.lr_f_base), 6, "params")


def test_multi_scene_step_equals_single_scene_steps(tmp_path):
    """Two scenes trained together equal each trained by its own
    ``Trainer`` (scene i from seed i), bitwise, step by step."""
    mt = _multi(W.conf_for([1, 1]), str(tmp_path / "multi"))
    mt.train()
    for i, ds in enumerate(_tiny_datasets(W.conf_for([1, 1]), 2)):
        conf = W.conf_for([1, 1], base=str(tmp_path / f"single{i}"))
        conf.train.epoch = W.EPOCHS
        tr = Trainer(conf, dataset=ds, device="cpu", seed=i)
        tr.train(stop_epoch=W.EPOCHS)
        _close(mt.scene_params(i), tr.params, 0.0, f"scene {i}")
        assert [h[i]["loss"] for h in mt.history] \
            == [h["loss"] for h in tr.history]


def test_multi_scene_step_function(tmp_path):
    """``multi_scene_train_step`` over two scenes' batches equals
    ``train_step`` on each (the JAX test_multi_scene_matches_single_scene
    with the port's own draws)."""
    conf = W.conf_for([1, 1])
    B, R = conf.train.batch_size, conf.train.n_rays
    batches = [W.step_inputs(conf, seed=s) for s in (1, 2)]
    cdfs = make_mc_cdfs(conf, B, R, device="cpu")
    args = (0.5, 1.0, 1e-3, 1e-3)
    params = [init_model(conf, seed=s, device="cpu") for s in (0, 1)]
    opts = [init_optimizer(p) for p in params]
    mons = multi_scene_train_step(params, opts, *zip(*batches), *args, 0,
                                  conf, cdfs=cdfs)
    for s in range(2):
        p = init_model(conf, seed=s, device="cpu")
        o = init_optimizer(p)
        m = train_step(p, o, *batches[s], *args, conf, cdfs=cdfs, step=0)
        assert m["loss"].item() == mons[s]["loss"].item()
        _close(params[s], p, 0.0, f"scene {s}")


def _folder_scenes(tmp_path):
    return [make_synthetic_scene(str(tmp_path / f"s{i}"), n_views=2, H=16,
                                 W=16, seed=i) for i in range(2)]


MULTI_E2E = ["parallel.mesh_shape=[1,1]", "train.epoch=3",
             "valid.epoch_interval=0", "valid.n_down_samples=2",
             "valid.n_rays=32", "extraction.grid_size=12",
             "extraction.rough_grid_size=12"]


def test_multi_scene_trainer_e2e_resume_and_scene_params(tmp_path):
    """Train two folder scenes two epochs (a checkpoint each), resume in a
    fresh trainer bitwise, train the third with the final per-scene
    validation (series, PSNR, meshes) in each scene's monitor directory."""
    scenes = _folder_scenes(tmp_path)
    over = MULTI_E2E + [f"monitor_base_path={tmp_path / 'mon'}"]
    t = MultiSceneTrainer(load_config("tiny_test", overrides=over), scenes,
                          device="cpu")
    t.train(epochs=2)
    for mp_ in t.monitor_paths:
        with open(os.path.join(mp_, "Training-loss.series.txt")) as f:
            assert len(f.read().splitlines()) == 2
        assert os.path.exists(os.path.join(mp_, "config.yaml"))
    assert sorted(os.listdir(t.ckpt_dir))[-1] == "ckpt_0000001.msgpack"

    t2 = MultiSceneTrainer(load_config("tiny_test", overrides=over), scenes,
                           device="cpu")
    assert t2.start_epoch == 2
    for i in range(2):
        _close(t2.scene_params(i), t.scene_params(i), 0.0, f"scene {i}")
        assert t2.opt_states[i]["count"] == t.opt_states[i]["count"] == 2
    t2.train(epochs=3)
    for mp_ in t2.monitor_paths:
        names = os.listdir(mp_)
        assert "PSNR-4x4.series.txt" in names, names
        assert any(n.endswith(".obj") for n in names), names
    d = (t2.scene_params(0)["geometric-network"]["affine-00"]["W"]
         - t2.scene_params(1)["geometric-network"]["affine-00"]["W"])
    assert float(d.abs().sum()) > 0


def test_multi_scene_resume_refuses_scene_mismatch(tmp_path):
    scenes = _folder_scenes(tmp_path)
    over = MULTI_E2E + ["train.epoch=1", "valid.skip=true",
                        f"monitor_base_path={tmp_path / 'mon'}"]
    MultiSceneTrainer(load_config("tiny_test", overrides=over), scenes,
                      device="cpu").train()
    with pytest.raises(ValueError, match="refusing to resume"):
        MultiSceneTrainer(load_config("tiny_test", overrides=over),
                          scenes[::-1], device="cpu")


def test_multi_scene_checkpoint_read_both_ways(tmp_path):
    """The JAX ``MultiSceneTrainer``'s stacked checkpoint resumes the
    port's trainer (parameters, moments and per-scene step counts, scene
    by scene), and the port's resumes the JAX trainer."""
    scenes = _folder_scenes(tmp_path)
    over = MULTI_E2E + ["valid.skip=true",
                        f"monitor_base_path={tmp_path / 'mon'}"]
    jt = JaxMultiSceneTrainer(jax_load_config("tiny_test", overrides=over),
                              scenes)
    mu = jax.tree_util.tree_map(lambda x: 0.5 * x.astype(jnp.float32),
                                jt.params_s)
    nu = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32) ** 2,
                                jt.params_s)
    jckpt.save_checkpoint(
        jt.ckpt_dir, 4, jt.params_s,
        OptState(adam=AdamState(count=jnp.asarray([3, 5], jnp.int32),
                                mu=mu, nu=nu)),
        extra={"scenes": scenes})

    pt = MultiSceneTrainer(load_config("tiny_test", overrides=over), scenes,
                           device="cpu")
    assert pt.start_epoch == 5
    jparams = jax.device_get(jt.params_s)
    jmu = jax.device_get(mu)
    for i in range(2):
        assert pt.opt_states[i]["count"] == [3, 5][i]
        for (path, v), (_, m) in zip(
                tree_leaves_with_path(pt.scene_params(i)),
                tree_leaves_with_path(pt.opt_states[i]["mu"])):
            jv, jm = jparams, jmu
            for k in path:
                jv, jm = jv[k], jm[k]
            np.testing.assert_array_equal(v.numpy(), np.asarray(jv)[i])
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm)[i])

    with torch.no_grad():  # the port's own state, then its checkpoint
        for i in range(2):
            for _, v in tree_leaves_with_path(pt.scene_params(i)):
                v.add_(0.25 * (i + 1))
            pt.opt_states[i]["count"] = 7 + i
    pt.save(6)
    jt2 = JaxMultiSceneTrainer(jax_load_config("tiny_test", overrides=over),
                               scenes)
    assert jt2.start_epoch == 7
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(jt2.opt_state_s.adam.count)), [7, 8])
    jp2 = jax.device_get(jt2.params_s)
    for i in range(2):
        for path, v in tree_leaves_with_path(pt.scene_params(i)):
            jv = jp2
            for k in path:
                jv = jv[k]
            np.testing.assert_array_equal(v.numpy(), np.asarray(jv)[i])


def test_plan_needs_a_process_group():
    """A mesh other than [1, 1] is a plan over torch.distributed ranks:
    without a process group of that size it refuses; [1, 1] is trivial."""
    assert ShardingPlan(W.conf_for([1, 1])).is_trivial
    with pytest.raises(ValueError, match="needs 2 processes"):
        ShardingPlan(W.conf_for([2, 1]))
