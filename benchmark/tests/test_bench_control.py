"""The control on the card at a size a test run holds: the reference in
the precision below the configuration's (TF32 matrix products) in the
program's place fails at least one of a cell's numbers at its committed
limits, while the reference against itself passes all of them.  The
default recipe's widths, its grid cut to 64^3, B=2, R=256, on the
fixture scene; the cells' own readings at full size are in PERF.md."""

import json
import os

import pytest

from benchmark import compare
from benchmark import scene as scene_mod
from benchmark.reference import follow
from conftest import REPO, TINY_SCENE

pytestmark = pytest.mark.cuda


def small_default():
    with open(os.path.join(REPO, "benchmark", "configs",
                           "default.json")) as f:
        c = json.load(f)["config"]
    c["geometric_network"]["voxel"]["grid_size"] = 64
    c["train"].update(batch_size=2, n_rays=256)
    return c


def limits(cell):
    with open(os.path.join(REPO, "benchmark", "checks",
                           f"{cell}.json")) as f:
        return {k: v["limit"] for k, v in json.load(f)["limits"].items()}


def test_training_control_fails(card):
    c = small_default()
    scene = scene_mod.make_scene(TINY_SCENE, 3, card)
    args = (c, scene, {"weights": 5, "data": 6}, {"start_epoch": 2}, 2,
            card)
    ref = follow.train_epoch(*args)
    lim = limits("default-dtu49-k8")
    same = compare.train_numbers(follow.train_epoch(*args), ref)
    ctrl = compare.train_numbers(follow.train_epoch(*args, tf32=True), ref)
    assert all(same[k] <= lim[k] for k in lim), same
    assert any(ctrl[k] > lim[k] for k in lim), ctrl


def test_render_control_fails(card):
    import numpy as np
    from benchmark.reference.data.cameras import load_K_Rt_from_P
    c = small_default()
    c["valid"]["n_rays"] = 192
    gen = __import__("torch").Generator(device=card)
    gen.manual_seed(4)
    cams = scene_mod.camera_arrays(*scene_mod.cameras(TINY_SCENE, gen, card))
    K, pose = load_K_Rt_from_P((cams["world_mat_0"]
                                @ cams["scale_mat_0"])[:3, :4])
    view = (pose[None].astype(np.float32),
            K[None, :3, :3].astype(np.float32), (64, 48), card)
    ref = follow.render_view(c, 8, *view, chunk=192)
    lim = limits("default-render-val")
    same = compare.render_numbers(follow.render_view(c, 8, *view,
                                                     chunk=192), ref)
    ctrl = compare.render_numbers(follow.render_view(c, 8, *view, chunk=192,
                                                     tf32=True), ref)
    assert all(same[k] <= lim[k] for k in lim), same
    assert any(ctrl[k] > lim[k] for k in lim), ctrl
