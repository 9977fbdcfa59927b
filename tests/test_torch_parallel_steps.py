"""The port's sharded ``train_steps`` and multi-scene step on the CPU, held
against the JAX package's one-program steps (``train_steps`` over
``ShardingPlan.shard_batch_steps`` on the conftest's 8-device virtual CPU
mesh, and the vmapped ``multi_scene_train_step``).

One spawned job of two gloo processes (``tests/
torch_parallel_steps_worker.py``) runs the port's sharded paths at mesh
``[1, 2]`` (rays over ranks) and ``[2, 1]`` (images over ranks), with
fixed and with fresh Monte-Carlo uniforms: its ``shard_batch_steps``, the
sharded ``train_steps`` of K = 3 steps from the JAX package's initial
weights and uniforms, the same steps as single ``train_step`` calls, and
its ``Trainer`` at ``steps_per_call`` 3 and 1.  On the CPU ``train_steps``
is a loop of ``train_step`` (on the card the replays of one captured step,
which ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold against the
eager steps), so the port is held bitwise against itself.  Against JAX,
as ``tests/test_torch_parallel.py`` and ``tests/test_torch_train_steps.py``
hold two implementations' steps: the first step's monitors at rtol 1e-4
(float32 sums of the batch in another order), the loss of every step at
rtol 1e-4; each trained parameter within 2 lr per update of the other's
(an Adam step moves an entry by ~lr sign(g), and where |g| is at float32
noise the sign may differ), at most 1e-3 of the entries per update beyond
1e-2 lr; each moment leaf within 2e-2 of its largest entry.
"""

import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import ndjir_tpu.train.optim as jopt
import torch_parallel_steps_worker as W
from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.models.fields import init_model as jax_init_model
from ndjir_tpu.parallel.mesh import ShardingPlan as JaxShardingPlan
from ndjir_tpu.parallel.multi_scene import (
    multi_scene_train_step as jax_multi_scene_train_step,
)
from ndjir_tpu.render.renderer import make_mc_cdfs as jax_make_mc_cdfs
from ndjir_tpu.train.trainer import train_steps as jax_train_steps

from ndjir_torch.bridge import params_from_numpy, params_to_numpy
from ndjir_torch.config import load_config
from ndjir_torch.parallel.multi_scene import multi_scene_train_step
from ndjir_torch.train.optim import init_optimizer, tree_leaves_with_path

torch.set_num_threads(2)

JOB_TIMEOUT_S = 300
K = 3
CASES = [(tuple(m), s) for m in W.MESHES for s in W.SEEDS]
IDS = [f"{m[0]}x{m[1]}-{s}" for m, s in CASES]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jconf(mesh, seeds):
    over = [*W.TINY, f"parallel.mesh_shape=[{mesh[0]},{mesh[1]}]",
            f"renderer.fixed_graph_seeds={str(seeds == 'fixed').lower()}"]
    return jax_load_config("default", overrides=over)


def _batches(conf, seed=11, lead=(K,)):
    """Batches (camloc, raydir, color, mask) with leading axes ``lead``,
    numpy float32 from a seed: cameras 2.5 from the origin, rays spread so
    that some miss the bounding sphere, random colours and mask."""
    B, R = conf.train.batch_size, conf.train.n_rays
    rng = np.random.RandomState(seed)
    camloc = np.tile(np.float32([0.1, -0.2, 2.5]), (*lead, B, 1))
    raydir = rng.randn(*lead, B, R, 3).astype(np.float32) * 0.5
    raydir[..., 2] -= 1.0
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    color = rng.rand(*lead, B, R, 3).astype(np.float32)
    mask = (rng.rand(*lead, B, R, 1) < 0.7).astype(np.float32)
    return camloc, raydir, color, mask


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's initial weights, K batches and uniforms (fixed,
    and fresh for steps STEP0 ...), written for the workers."""
    jconf, fresh = _jconf([1, 1], "fixed"), _jconf([1, 1], "fresh")
    B, R = jconf.train.batch_size, jconf.train.n_rays
    draw = jax.jit(lambda s: jax_make_mc_cdfs(fresh, B, R, step=s))
    out = dict(
        params=_np(jax.jit(lambda k: jax_init_model(k, jconf))(
            jax.random.PRNGKey(0))),
        batches=_batches(jconf),
        fixed=_np(jax.jit(lambda: jax_make_mc_cdfs(jconf, B, R))()),
        fresh=[_np(draw(jnp.int32(W.STEP0 + j))) for j in range(K)])
    path = str(tmp_path_factory.mktemp("steps_ref") / "ref.pt")
    torch.save(out, path)
    return out, path


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def job(ref, tmp_path_factory):
    """Both ranks' results of the two-process gloo job."""
    out = str(tmp_path_factory.mktemp("gloo_steps"))
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=W.run, args=(r, port, out, ref[1]))
             for r in (0, 1)]
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
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in (0, 1)]


@pytest.mark.parametrize("mesh", W.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_shard_batch_steps_matches_jax_slices(ref, job, mesh):
    """Each rank's ``shard_batch_steps`` of the (K, B, ...) batches equals,
    bitwise, the shard the JAX package's puts on the device at the same
    place of the mesh (rank d * rays + r on mesh device [d, r]); the K
    axis is kept whole."""
    jplan = JaxShardingPlan(_jconf(mesh, "fixed"))
    put = jplan.shard_batch_steps(*ref[0]["batches"])
    for rank, res in enumerate(job):
        dev = jplan.mesh.devices[rank // mesh[1], rank % mesh[1]]
        for got, arr in zip(res["shards"][tuple(mesh)], put):
            (shard,) = [s for s in arr.addressable_shards if s.device == dev]
            want = np.asarray(shard.data)
            assert got.shape[0] == K
            np.testing.assert_array_equal(got, want)


def _jax_sharded_steps(ref, mesh, seeds):
    jconf = _jconf(mesh, seeds)
    plan = JaxShardingPlan(jconf)
    p = plan.replicate(jax.tree_util.tree_map(jnp.asarray, ref["params"]))
    s = plan.replicate(jopt.init_optimizer(p))
    cdfs = jax.tree_util.tree_map(jnp.asarray, ref["fixed"]) \
        if seeds == "fixed" else None
    p, s, mons = jax_train_steps(
        p, s, *plan.shard_batch_steps(*ref["batches"]),
        *map(jnp.float32, W.SCHED), jnp.int32(W.STEP0), jconf, cdfs=cdfs)
    return _np(p), _np(s), _np(mons)


def _params_close(got, want, lr, updates, what=""):
    moved, n = 0, 0
    for path, w in tree_leaves_with_path(want):
        g = got
        for k in path:
            g = g[k]
        diff = np.abs(np.asarray(g, np.float64) - w)
        assert diff.max() <= 2 * lr * updates, (what, path)
        moved += int(np.sum(diff > 1e-2 * lr))
        n += w.size
    assert moved <= 1e-3 * updates * n, (what, moved, n)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_train_steps_matches_jax(ref, job, case):
    """The sharded ``train_steps`` over two gloo ranks against the JAX
    ``train_steps`` on the same mesh of virtual CPU devices, from the same
    weights, batches and uniforms (module docstring's tolerances)."""
    mesh, seeds = case
    (p, s, mons), _ = job[0]["steps"][case]
    jp, js, jmons = _jax_sharded_steps(ref[0], mesh, seeds)
    assert int(s["count"]) == int(js.adam.count) == K
    for k, v in jmons.items():
        if k == "grads_finite":
            assert mons[k].tolist() == v.tolist() == [True] * K
            continue
        np.testing.assert_allclose(mons[k][0].item(), v[0], rtol=1e-4,
                                   atol=1e-8, err_msg=k)
    np.testing.assert_allclose(mons["loss"].numpy(), jmons["loss"],
                               rtol=1e-4)
    lr = max(W.SCHED[2:])
    _params_close(params_to_numpy(p), jp, lr, K, "params")
    for name in ("mu", "nu"):
        mine = params_to_numpy(s[name])
        for path, w in tree_leaves_with_path(getattr(js.adam, name)):
            g = mine
            for k in path:
                g = g[k]
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max() + 1e-12, \
                (name, path)


def _state_equal(a, b):
    for (path, x), (_, y) in zip(tree_leaves_with_path(a),
                                 tree_leaves_with_path(b)):
        assert torch.equal(x, y), path


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_train_steps_equals_single_steps_bitwise(job, case):
    """On every rank, the sharded ``train_steps`` of K steps equals K
    sharded ``train_step`` calls bitwise: state and monitors.  Both ranks
    hold the same parameters after every all-reduced update."""
    for res in job:
        (p, s, mons), (p1, s1, mons1) = res["steps"][case]
        _state_equal(p, p1)
        _state_equal(s["mu"], s1["mu"])
        _state_equal(s["nu"], s1["nu"])
        assert torch.equal(s["count"], s1["count"])
        for k in mons:
            assert torch.equal(mons[k], torch.stack([m[k] for m in mons1])), k
    _state_equal(job[0]["steps"][case][0][0], job[1]["steps"][case][0][0])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_trainer_steps_per_call_3_equals_1(job, case):
    """The port's ``Trainer`` over two gloo ranks: three steps an epoch
    in one ``train_steps`` call (``steps_per_call: 3``) give the history,
    parameters and moments of one step a call, bitwise, on each rank (the
    second epoch trains at a learning rate above 0)."""
    for res in job:
        (p3, o3, h3), (p1, o1, h1) = res["trainer"][case]
        assert len(h3) == len(h1) == W.TRAINER_EPOCHS * 3
        assert h3 == h1
        assert all(m["grads_finite"] for m in h3)
        _state_equal(p3, p1)
        _state_equal(o3["mu"], o1["mu"])
        assert torch.equal(o3["count"], o1["count"])
        assert int(o3["count"]) == W.TRAINER_EPOCHS * 3


def test_multi_scene_step_matches_jax():
    """``multi_scene_train_step`` over S=2 scenes (``tiny_test``, scene i
    from JAX ``init_model(PRNGKey(i))``) against the JAX package's vmapped
    ``multi_scene_train_step``, handed the uniforms JAX draws inside its
    step: each scene's monitors at rtol 1e-4 and its trained parameters to
    the module docstring's tolerance for one update."""
    jconf, conf = jax_load_config("tiny_test"), load_config("tiny_test")
    B, R, S, step = jconf.train.batch_size, jconf.train.n_rays, 2, 7
    plist = [_np(jax.jit(lambda k: jax_init_model(k, jconf))(
        jax.random.PRNGKey(i))) for i in range(S)]
    batches = _batches(jconf, seed=3, lead=(S,))
    params_s = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *plist)
    opt_s = jax.tree_util.tree_map(
        lambda *a: jnp.stack(a), *[jopt.init_optimizer(p) for p in plist])
    sched = (0.37, 0.9, 1e-3, 2e-3)
    jp, _, jmons = jax_multi_scene_train_step(
        params_s, opt_s, *map(jnp.asarray, batches),
        *map(jnp.float32, sched), jnp.int32(step), jconf)
    jp, jmons = _np(jp), _np(jmons)

    cdfs = _np(jax.jit(lambda s: jax_make_mc_cdfs(jconf, B, R, step=s))(
        jnp.int32(step)))
    cdfs = {k: [torch.from_numpy(u) for u in v] if isinstance(v, list)
            else torch.from_numpy(v) for k, v in cdfs.items()}
    params = [params_from_numpy(p, device="cpu") for p in plist]
    opts = [init_optimizer(p) for p in params]
    mons = multi_scene_train_step(
        params, opts, *([torch.from_numpy(a[i]) for i in range(S)]
                        for a in batches),
        *sched, step, conf, cdfs=cdfs)
    for i in range(S):
        for k, v in jmons.items():
            if k == "grads_finite":
                assert bool(mons[i][k]) and bool(v[i])
                continue
            np.testing.assert_allclose(mons[i][k].item(), v[i], rtol=1e-4,
                                       atol=1e-8, err_msg=f"scene {i} {k}")
        _params_close(params_to_numpy(params[i]),
                      jax.tree_util.tree_map(lambda a, i=i: a[i], jp),
                      max(sched[2:]), 1, f"scene {i}")
