"""One rank of the two-process gloo job of
``tests/test_torch_parallel_steps.py`` (imports torch and the port only).

Rank r reads the test's inputs (the JAX package's initial weights, K
batches and Monte-Carlo uniforms, as numpy), and at mesh ``[1, 2]`` and
``[2, 1]``: takes its ``shard_batch_steps`` of the batches, runs the
sharded ``train_steps`` from the JAX weights with fixed and with fresh
uniforms, and the same K steps as single sharded ``train_step`` calls;
then trains the port's ``Trainer`` (its own weights) at
``steps_per_call`` 3 and 1.  Each rank saves what it got with
``torch.save``; the test holds it against JAX and against itself."""

from __future__ import annotations

import os

import numpy as np
import torch

from torch_parallel_worker import TINY, datasets

MESHES = ([1, 2], [2, 1])
SEEDS = ("fixed", "fresh")
SCHED = (0.37, 0.9, 1e-3, 2e-3)   # cos-anneal, lv gain, lr weight, lr feat
STEP0 = 5                          # the call's first global step
# the Trainer: 6 views at B=2 are 3 steps an epoch, one call of 3; no
# warm-up, so epoch 1 (the schedule lags one epoch) moves every leaf
TRAINER_VIEWS, TRAINER_EPOCHS = 6, 2


def conf_for(mesh, seeds, extra=()):
    from ndjir_torch.config import load_config

    over = [*TINY, f"parallel.mesh_shape=[{mesh[0]},{mesh[1]}]",
            f"renderer.fixed_graph_seeds={str(seeds == 'fixed').lower()}",
            *extra]
    return load_config("default", overrides=over)


def _cdfs(tree):
    return {k: [torch.from_numpy(u) for u in v] if isinstance(v, list)
            else torch.from_numpy(v) for k, v in tree.items()}


def sharded_steps(plan, conf, ref, seeds):
    """(state after ``train_steps``, its monitors, state after K single
    ``train_step`` calls, theirs): the same sharded steps both ways."""
    from ndjir_torch.bridge import params_from_numpy
    from ndjir_torch.train.optim import init_optimizer
    from ndjir_torch.train.trainer import train_step, train_steps

    batches = plan.shard_batch_steps(*map(torch.from_numpy, ref["batches"]))
    fixed = plan.shard_cdfs(_cdfs(ref["fixed"])) if seeds == "fixed" \
        else None

    def step_cdfs(g):
        return plan.shard_cdfs(_cdfs(ref["fresh"][g - STEP0]))

    p = params_from_numpy(ref["params"], device="cpu")
    s = init_optimizer(p)
    mons = train_steps(p, s, *batches, *SCHED, STEP0, conf, cdfs=fixed,
                       reducer=plan.reducer, step_cdfs=step_cdfs)
    p1 = params_from_numpy(ref["params"], device="cpu")
    s1 = init_optimizer(p1)
    mons1 = [train_step(p1, s1, *(b[j] for b in batches), *SCHED, conf,
                        cdfs=fixed if fixed is not None
                        else step_cdfs(STEP0 + j),
                        step=STEP0 + j, reducer=plan.reducer)
             for j in range(batches[0].shape[0])]
    return (p, s, mons), (p1, s1, mons1)


def trainer_run(mesh, seeds, spc, out, rank):
    """The port's ``Trainer`` at ``steps_per_call`` ``spc``: (parameters,
    history)."""
    from ndjir_torch.train.trainer import Trainer

    conf = conf_for(mesh, seeds, [
        f"train.steps_per_call={spc}", "train.warmup_term_ratio=0",
        "train.mask_weight=0.1", "train.checkpoint_interval_epochs=0",
        f"monitor_base_path={out}/tr_{mesh[0]}x{mesh[1]}_{seeds}_{spc}_r"
        f"{rank}/mon"])
    ds = datasets(conf, 1, views=TRAINER_VIEWS)[0]
    tr = Trainer(conf, dataset=ds, device="cpu", seed=0)
    tr.train(stop_epoch=TRAINER_EPOCHS)
    return tr.params, tr.opt_state, tr.history


def run(rank: int, port: int, out: str, ref_path: str) -> None:
    from ndjir_torch.parallel.mesh import ShardingPlan
    from ndjir_torch.parallel.multi_scene import initialize_distributed

    # the test's own thread count: the CPU scatter's sums follow it
    torch.set_num_threads(2)
    initialize_distributed(f"localhost:{port}", 2, rank, device="cpu")
    ref = torch.load(ref_path, weights_only=False)
    res = {"shards": {}, "steps": {}, "trainer": {}}
    for mesh in MESHES:
        conf = conf_for(mesh, "fixed")
        plan = ShardingPlan(conf)
        res["shards"][tuple(mesh)] = [
            t.numpy() for t in plan.shard_batch_steps(
                *map(torch.from_numpy, ref["batches"]))]
        for seeds in SEEDS:
            conf = conf_for(mesh, seeds)
            res["steps"][tuple(mesh), seeds] = sharded_steps(
                ShardingPlan(conf), conf, ref, seeds)
            res["trainer"][tuple(mesh), seeds] = [
                trainer_run(mesh, seeds, spc, out, rank) for spc in (3, 1)]
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
