"""The port's ``Trainer`` on the CPU at a tiny size: the epoch schedule's
one-epoch lag, the step record, its checkpoint, and what it refuses
because it is not ported yet.  Its arithmetic is held against the JAX
reference by ``tests/test_torch_slice.py``."""

import os

import numpy as np
import pytest
import torch

from ndjir_torch.config import load_config
from ndjir_torch.data.dataset import IDRDataset
from ndjir_torch.data.synthetic import render_sphere_scene
from ndjir_torch.train import schedules
from ndjir_torch.train.optim import tree_leaves_with_path
from ndjir_torch.train.trainer import Trainer

torch.set_num_threads(2)

TINY = ["valid.skip=true", "data_path=synthetic/sphere",
        "geometric_network.voxel.grid_size=16", "train.batch_size=2",
        "train.n_rays=8", "geometric_network.feature_size=64",
        "renderer.n_samples0=8", "renderer.n_samples1=4",
        "renderer.n_bg_samples=4", "renderer.n_thetas=2"]


def _trainer(tmp_path, extra=()):
    conf = load_config("default", overrides=TINY + [
        f"monitor_base_path={tmp_path}/mon", *extra])
    images, masks, cameras = render_sphere_scene(n_views=4, H=16, W=16)
    ds = IDRDataset(conf, images, masks, cameras, train=True, shuffle=True)
    return Trainer(conf, dataset=ds, device="cpu", seed=0)


def _snapshot(params):
    return {p: v.clone() for p, v in tree_leaves_with_path(params)}


def test_lr_follows_the_lagged_schedule_then_every_leaf_moves(tmp_path):
    tr = _trainer(tmp_path)
    assert tr.ds.iters_per_epoch == 2
    init = _snapshot(tr.params)
    # the schedules update at the end of an epoch, so epoch e trains at
    # the learning rate of e - 1, and epoch 0 at 0; the linear warmup
    # makes that of epoch 0 zero too, so epochs 0 and 1 leave the
    # parameters alone
    lr_w, lr_f = tr.lr_w_base, tr.lr_f_base
    assert schedules.learning_rate(0, lr_w, tr.conf) == 0.0
    assert schedules.learning_rate(1, lr_f, tr.conf) > 0.0
    tr.train(stop_epoch=2)
    for p, v in tree_leaves_with_path(tr.params):
        assert torch.equal(v, init[p]), p
    assert tr.opt_state["count"] == 4        # the moments still advance
    tr.train(stop_epoch=3)
    assert tr.start_epoch == 3
    for p, v in tree_leaves_with_path(tr.params):
        assert not torch.equal(v, init[p]), p
    assert len(tr.history) == 6
    for m in tr.history:
        assert m["grads_finite"] and np.isfinite(m["loss"])
    # the monitor series files get one line per step
    with open(f"{tr.monitor_path}/Training-loss.series.txt") as f:
        assert len(f.read().splitlines()) == 6


@pytest.mark.parametrize("overrides,item", [
    # validation (A8) is ported; on a DTU scene its final Chamfer
    # evaluation (A11) is not, so the case keeps its id and names A11
    pytest.param(["valid.skip=false", "data_path=DTU/scan65"], "A11",
                 id="valid.skip=false-A8"),
    (["parallel.mesh_shape=[2, 1]"], "A14"),
    # the bf16 MLP is ported; the production preset with head
    # rematerialization is not yet
    pytest.param(["precision.mlp_dtype=bfloat16", "train.remat_heads=true"],
                 "A13", id="precision.mlp_dtype=bfloat16-A13"),
    (["renderer.fixed_graph_seeds=false"], "A13"),
    (["renderer.proposal_method=coarse_grid"], "A13"),
], ids=lambda v: v[0] if isinstance(v, list) else v)
def test_refuses_what_is_not_ported(tmp_path, overrides, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        _trainer(tmp_path, overrides)


def test_refuses_to_reach_a_checkpoint(tmp_path):
    """Checkpoints (A7) are ported: reaching one no longer refuses, it
    saves the epoch's checkpoint (tests/test_torch_checkpoint.py holds the
    file against the JAX package's)."""
    tr = _trainer(tmp_path, ["train.checkpoint_interval_epochs=1"])
    tr.train(stop_epoch=1)
    assert sorted(os.listdir(os.path.join(tr.monitor_path, "checkpoints"))) \
        == ["ckpt_0000000.json", "ckpt_0000000.msgpack"]
