"""The plain reference against the port's plain path on the CPU at
``tiny_test``: the weights, the data layer's batches, a training step
(sampler, grid query and its scatter backward, fields, BRDF, the nine
loss terms with the eikonal double backward, Adam with its skip), and a
rendered view (image, normal and mask maps), each from the same inputs."""

import numpy as np
import pytest
import torch

from benchmark import scene as scene_mod
from benchmark.reference import follow, weights
from benchmark.reference.config import Config as RefConfig
from benchmark.reference.data.batches import Batches
from conftest import TINY_SCENE, tiny_config


def leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    return tiny_config(), scene_mod.make_scene(TINY_SCENE, 11, "cpu")


def test_weights_follow_the_port_init_laws(tiny):
    """The benchmark's draw and the port's own ``init_model`` follow the
    same laws; for one seed on the CPU they give the same tree."""
    from ndjir_torch.config import Config
    from ndjir_torch.models.fields import init_model
    conf, _ = tiny
    mine = dict(leaves(weights.draw(conf, 7, "cpu")))
    port = dict(leaves(init_model(Config(conf), seed=7, device="cpu")))
    assert mine.keys() == port.keys()
    for k in mine:
        assert torch.equal(mine[k], port[k]), k


def test_load_into_refuses_a_different_tree(tiny):
    conf, _ = tiny
    w = weights.draw(conf, 1, "cpu")
    other = weights.draw(conf, 2, "cpu")
    weights.load_into(other, w)
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(leaves(w), leaves(other)))
    del other["roughness-network"]
    with pytest.raises(ValueError):
        weights.load_into(other, w)


def test_batches_are_the_port_data_layers(tiny):
    from ndjir_torch.config import Config
    from ndjir_torch.data.dataset import IDRDataset
    from ndjir_torch.train.trainer import Trainer
    conf, scene = tiny
    c = Config(dict(conf, data_path="bench/x"))
    ds = IDRDataset(c, *scene, train=True, shuffle=True,
                    rng=np.random.RandomState(5))
    ref = Batches(*scene, conf["train"]["n_rays"], np.random.RandomState(5))
    B = conf["train"]["batch_size"]
    for _ in range(5):   # past an epoch of the 4 views: a re-draw
        got = Trainer._host_batch(type("T", (), {"ds": ds, "conf": c})())
        want = ref.next(B)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_training_step_is_the_ports(tiny):
    """Three steps from the same weights and draws: losses, moments and
    parameters as the port's plain path computes them."""
    from ndjir_torch.config import Config
    from ndjir_torch.render.renderer import make_mc_cdfs
    from ndjir_torch.train.optim import init_optimizer
    from ndjir_torch.train.trainer import train_step
    conf, scene = tiny
    seeds = {"weights": 3, "data": 4}
    traffic = {"start_epoch": 2}
    ref = follow.train_epoch(conf, scene, seeds, traffic, 3, "cpu")

    c = Config(conf)
    params = weights.draw(conf, 3, "cpu")
    opt = init_optimizer(params)
    batches = Batches(*scene, conf["train"]["n_rays"],
                      np.random.RandomState(4))
    cdfs = make_mc_cdfs(c, conf["train"]["batch_size"],
                        conf["train"]["n_rays"], device="cpu")
    sched = follow.epoch_scalars(RefConfig(conf), 2, "cpu")
    losses = []
    for _ in range(3):
        batch = [torch.from_numpy(a) for a in
                 batches.next(conf["train"]["batch_size"])]
        losses.append(float(train_step(params, opt, *batch, *sched, c,
                                       cdfs=cdfs)["loss"]))
    assert losses == ref["losses"]
    assert follow.leaf_norms(opt["mu"]) == ref["moments"]
    p0 = dict(leaves(ref["p0"]))
    for k, p in leaves(params):
        assert abs(float(torch.linalg.vector_norm(p - p0[k]))
                   - ref["changes"]["/".join(k)]) == 0.0


def test_rendered_view_is_the_ports(tiny):
    from ndjir_torch.config import Config
    from ndjir_torch.render.image import render_image
    from benchmark.reference.data.cameras import load_K_Rt_from_P
    conf, scene = tiny
    cams = scene[2]
    P = (cams["world_mat_1"] @ cams["scale_mat_1"])[:3, :4]
    K, pose = load_K_Rt_from_P(P)
    pose, K = pose[None].astype(np.float32), K[None, :3, :3].astype(
        np.float32)
    res = (TINY_SCENE["width"], TINY_SCENE["height"])
    port = render_image(weights.draw(conf, 9, "cpu"), pose, K, res,
                        Config(conf), return_aux=True)
    for chunk in (None, 256):
        ref = follow.render_view(conf, 9, pose, K, res, "cpu",
                                 chunk=chunk or conf["valid"]["n_rays"])
        for a, b in zip(port, ref):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_scene_is_drawn_from_the_seed():
    a = scene_mod.make_scene(TINY_SCENE, 1, "cpu")
    b = scene_mod.make_scene(TINY_SCENE, 1, "cpu")
    c = scene_mod.make_scene(TINY_SCENE, 2, "cpu")
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == (4, 48, 64, 3) and a[1].shape == (4, 48, 64)
    share = (a[1] > 0).mean()
    assert 0.05 < share < 0.9      # the object covers part of each view
