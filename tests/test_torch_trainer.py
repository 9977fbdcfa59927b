"""The port's ``Trainer`` on the CPU at a tiny size: the epoch schedule's
one-epoch lag, the step record, its checkpoint, an IDR folder with the DTU
Chamfer hook of the final validation, and the opt-ins it refused before
they were ported.  Its arithmetic is held against the JAX reference by
``tests/test_torch_slice.py``, its command line by
``tests/test_torch_cli.py``."""

import os

import numpy as np
import pytest
import torch

from ndjir_torch.config import load_config
from ndjir_torch.data.dataset import IDRDataset
from ndjir_torch.data.synthetic import (
    make_synthetic_scene,
    render_sphere_scene,
)
from ndjir_torch.train import schedules
from ndjir_torch.train.optim import tree_leaves_with_path
from ndjir_torch.train.trainer import Trainer
from ndjir_torch.utils.mesh_io import save_ply_points

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
    (["parallel.mesh_shape=[2, 1]"], "A14"),
    # the production preset with head rematerialization
    pytest.param(["precision.mlp_dtype=bfloat16", "train.remat_heads=true"],
                 "A13", id="precision.mlp_dtype=bfloat16-A13"),
    (["renderer.fixed_graph_seeds=false"], "A13"),
    (["renderer.proposal_method=coarse_grid"], "A13"),
], ids=lambda v: v[0] if isinstance(v, list) else v)
def test_refuses_what_is_not_ported(tmp_path, overrides, item):
    """What ROADMAP A13 and A14 ported is refused no longer: each opt-in
    trains an epoch, and a sharded mesh asks for the process group it runs
    in (``tests/test_torch_parallel.py`` runs it over gloo)."""
    if item == "A14":
        with pytest.raises(ValueError, match="needs 2 processes"):
            _trainer(tmp_path, overrides)
        return
    tr = _trainer(tmp_path, overrides)
    tr.train(stop_epoch=1)
    assert len(tr.history) == 2
    for m in tr.history:
        assert m["grads_finite"] and np.isfinite(m["loss"])


def test_refuses_to_reach_a_checkpoint(tmp_path):
    """Checkpoints (A7) are ported: reaching one no longer refuses, it
    saves the epoch's checkpoint (tests/test_torch_checkpoint.py holds the
    file against the JAX package's)."""
    tr = _trainer(tmp_path, ["train.checkpoint_interval_epochs=1"])
    tr.train(stop_epoch=1)
    assert sorted(os.listdir(os.path.join(tr.monitor_path, "checkpoints"))) \
        == ["ckpt_0000000.json", "ckpt_0000000.msgpack"]


def test_reads_a_dtu_folder_and_scores_the_final_mesh(tmp_path):
    """``Trainer(conf)`` with no dataset reads ``data_path``; the final
    validation on a ``DTU*/scanN`` path scores the extracted mesh against
    ``valid.dtumvs.ref_dir`` and writes the Chamfer series and the colored
    error clouds to the monitor directory."""
    scene = make_synthetic_scene(str(tmp_path / "DTU" / "scan7"), n_views=4,
                                 H=16, W=16)
    ref = tmp_path / "ref" / "Points" / "stl"
    ref.mkdir(parents=True)
    u = np.random.RandomState(0).randn(3000, 3)
    save_ply_points(str(ref / "stl007_total.ply"),
                    0.5 * u / np.linalg.norm(u, axis=1, keepdims=True))
    conf = load_config("default", overrides=[
        o for o in TINY if not o.startswith(("valid.skip", "data_path"))] + [
        f"data_path={scene}", f"monitor_base_path={tmp_path}/mon",
        "valid.skip=false", "train.epoch=1", "valid.n_rays=64",
        "extraction.grid_size=24", "extraction.rough_grid_size=24",
        "extraction.batch_size=4096", f"valid.dtumvs.ref_dir={tmp_path}/ref",
        "valid.dtumvs.downsample_density=0.05"])
    tr = Trainer(conf, device="cpu", seed=0)
    assert tr.ds.size == 4 and (tr.ds.H, tr.ds.W) == (16, 16)
    tr.train()
    names = os.listdir(tr.monitor_path)
    series = sorted(n for n in names if n.startswith("Chamfer-Distance"))
    assert len(series) == 3, names
    for name in series:
        with open(os.path.join(tr.monitor_path, name)) as f:
            index, value = f.read().split()
        assert index == "0" and np.isfinite(float(value))
    assert "vis_007_d2s.ply" in names and "vis_007_s2d.ply" in names
    assert conf.valid.dtumvs.scan == "scan7"
