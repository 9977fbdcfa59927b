"""One rank of the two-process gloo job of ``tests/test_torch_parallel.py``
(imports torch and the port only, so a spawned rank starts quickly).

Every rank builds the same inputs from numpy seeds, runs the sharded paths
of ``ndjir_torch.parallel`` and rank 0 saves what came out with
``torch.save``; the test holds it against the unsharded run in its own
process."""

from __future__ import annotations

import os

import numpy as np
import torch

from ndjir_torch.config import load_config
from ndjir_torch.data.dataset import IDRDataset
from ndjir_torch.data.synthetic import render_sphere_scene

TINY = ["valid.skip=true", "data_path=synthetic/sphere",
        "geometric_network.voxel.grid_size=16", "train.batch_size=2",
        "train.n_rays=8", "geometric_network.feature_size=64",
        "renderer.n_samples0=8", "renderer.n_samples1=4",
        "renderer.n_bg_samples=4", "renderer.n_thetas=2"]
# (mesh_shape, mask_weight): rays split, then images; with the mask term the
# RGB loss divides by sum(obj_mask), without it by B*R
STEP_CASES = [([1, 2], 0.0), ([1, 2], 0.1), ([2, 1], 0.0), ([2, 1], 0.1)]
# the sharded trainer also draws fresh Monte-Carlo uniforms every step
TRAINER_EXTRA = ["renderer.fixed_graph_seeds=false", "train.mask_weight=0.1"]
MULTI_SHAPES = ([2, 1], [1, 2])
EPOCHS = 3  # epochs 0 and 1 train at lr 0; epoch 2 moves every leaf


def conf_for(mesh, extra=(), base=None):
    over = TINY + [f"parallel.mesh_shape=[{mesh[0]},{mesh[1]}]", *extra]
    if base is not None:
        over.append(f"monitor_base_path={base}")
    return load_config("default", overrides=over)


def step_inputs(conf, seed: int = 5):
    """(camloc, raydir, color, obj_mask) of one batch, from a numpy seed:
    cameras 2.5 from the origin looking towards it, spread so that some
    rays miss the bounding sphere (the shards' counts of hits differ),
    random colors, a random object mask."""
    B, R = conf.train.batch_size, conf.train.n_rays
    rng = np.random.RandomState(seed)
    camloc = np.tile(np.float32([[0.0, 0.0, 2.5]]), (B, 1))
    raydir = rng.randn(B, R, 3).astype(np.float32) * 0.5
    raydir[..., 2] -= 1.0
    raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
    color = rng.rand(B, R, 3).astype(np.float32)
    mask = (rng.rand(B, R, 1) < 0.6).astype(np.float32)
    return [torch.from_numpy(a) for a in (camloc, raydir, color, mask)]


def datasets(conf, n: int):
    """``n`` in-memory sphere scenes of 4 views at 16x16, radius 0.5, 0.4,
    ..., each its own dataset (with the same ray draws: each dataset seeds
    its own generator)."""
    out = []
    for i in range(n):
        images, masks, cameras = render_sphere_scene(
            n_views=4, H=16, W=16, radius=0.5 - 0.1 * i)
        out.append(IDRDataset(conf, images, masks, cameras, train=True,
                              shuffle=True))
    return out


def sharded_step(conf, mask_weight):
    """(loss, monitors, grads, the mean of the shards' own losses) of one
    step's loss and gradients, sharded by ``conf.parallel.mesh_shape``."""
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.parallel.mesh import ShardingPlan
    from ndjir_torch.render.renderer import make_mc_cdfs
    from ndjir_torch.train.trainer import loss_and_grads

    conf.train.mask_weight = mask_weight
    B, R = conf.train.batch_size, conf.train.n_rays
    plan = ShardingPlan(conf)
    params = init_model(conf, seed=0, device="cpu")
    batch = plan.shard_batch(*step_inputs(conf))
    cdfs = plan.shard_cdfs(make_mc_cdfs(conf, B, R, device="cpu"))
    args = (0.5, 1.0, conf)
    loss, mons, grads = loss_and_grads(params, *batch, *args, cdfs=cdfs,
                                       reduce_counts=plan.reducer.counts)
    plan.reducer.grads(grads)
    mons = plan.reducer.monitors(mons)
    # what averaging each shard's own loss (DDP's mean) would report
    own, _, _ = loss_and_grads(params, *batch, *args, cdfs=cdfs)
    own = own.reshape(1).clone()
    torch.distributed.all_reduce(own)
    return mons, grads, own.item() / plan.world_size


def run(rank: int, port: int, out: str) -> None:
    from ndjir_torch.parallel.multi_scene import (
        MultiSceneTrainer,
        initialize_distributed,
    )
    from ndjir_torch.train.trainer import Trainer

    # the test's own thread count: the CPU scatter's sums follow it
    torch.set_num_threads(2)
    initialize_distributed(f"localhost:{port}", 2, rank, device="cpu")
    res = {"steps": [sharded_step(conf_for(mesh), w)
                     for mesh, w in STEP_CASES]}

    conf = conf_for([1, 2], TRAINER_EXTRA, f"{out}/trainer_r{rank}/mon")
    tr = Trainer(conf, dataset=datasets(conf, 1)[0], device="cpu", seed=0)
    tr.train(stop_epoch=EPOCHS)
    res["trainer"] = (tr.params, tr.history)

    res["multi"] = {}
    for mesh in MULTI_SHAPES:
        conf = conf_for(mesh, base=f"{out}/multi_{mesh[0]}x{mesh[1]}/mon")
        conf.train.epoch = EPOCHS
        mt = MultiSceneTrainer(conf, [f"{out}/s0", f"{out}/s1"],
                               datasets=datasets(conf, 2), device="cpu")
        mt.train()
        res["multi"][tuple(mesh)] = mt.ckpt_dir
    if rank == 0:
        torch.save(res, os.path.join(out, "rank0.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
