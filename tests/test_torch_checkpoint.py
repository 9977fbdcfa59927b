"""The port's checkpoints against the JAX package's (CPU), resume, and the
trainer's validation outputs.

The port writes ``flax.serialization.to_bytes`` of the JAX package's state
byte for byte, so each package reads the other's files: held here with the
same parameter values on both sides (the JAX ``init_model`` tree, bridged)
and optimizer moments made from a seed, at an f32 grid and at a bf16 grid,
for the dense voxel, triplaneline and voxel-hash leaf layouts, and with
arrays split into chunks (flax's ``MAX_CHUNK_SIZE`` lowered on
both sides).  Resuming is bitwise the uninterrupted run on the CPU.
"""

import functools
import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndjir_tpu.config import load_config as jax_load_config
from ndjir_tpu.models.fields import init_model as jax_init_model
from ndjir_tpu.train import checkpoint as jckpt
from ndjir_tpu.train.optim import AdamState, OptState

from ndjir_torch.bridge import params_from_numpy
from ndjir_torch.config import load_config
from ndjir_torch.data.dataset import IDRDataset
from ndjir_torch.data.synthetic import render_sphere_scene
from ndjir_torch.models.fields import init_model
from ndjir_torch.train import checkpoint
from ndjir_torch.train.optim import init_optimizer, tree_leaves_with_path
from ndjir_torch.train.trainer import Trainer

torch.set_num_threads(2)

SMALL = ["geometric_network.voxel.grid_size=16",
         "geometric_network.feature_size=64"]
BF16 = ["precision.grid_dtype=bfloat16"]
TRIPLANELINE = ["geometric_network.voxel.type=triplaneline",
                "geometric_network.voxel.feature_size=8"]
HASH = ["geometric_network.voxel.type=voxel_hash",
        "geometric_network.voxel.hash_levels=4"]
# the leaf layouts: a dense voxel F, triplaneline's plane_F and line_F, the
# voxel hash's flat F; bf16 grids give every grid leaf that dtype
RUNS = {"f32": SMALL, "bf16": SMALL + BF16,
        "triplaneline": SMALL + TRIPLANELINE,
        "triplaneline_bf16": SMALL + TRIPLANELINE + BF16,
        "voxel_hash_bf16": SMALL + HASH + BF16}

TINY = ["data_path=synthetic/sphere", "geometric_network.voxel.grid_size=16",
        "train.batch_size=2", "train.n_rays=8",
        "geometric_network.feature_size=64", "renderer.n_samples0=8",
        "renderer.n_samples1=4", "renderer.n_bg_samples=4",
        "renderer.n_thetas=2"]


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


@functools.lru_cache(maxsize=None)
def _states(run):
    """The same state on both sides: JAX (params, OptState) and the
    port's (params, {"count", "mu", "nu"}), moments from a seed; made once
    per run and only read by the tests."""
    jconf = jax_load_config("default", overrides=RUNS[run])
    conf = load_config("default", overrides=RUNS[run])
    jparams = jax.jit(lambda k: jax_init_model(k, jconf))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    mu = jax.tree_util.tree_map(
        lambda p: rng.randn(*p.shape).astype(np.float32), jparams)
    nu = jax.tree_util.tree_map(
        lambda p: rng.rand(*p.shape).astype(np.float32), jparams)
    jopt = OptState(adam=AdamState(jnp.int32(7), mu, nu))
    params = params_from_numpy(_np(jparams), device="cpu", conf=conf)
    opt = {"count": 7,
           "mu": params_from_numpy(mu, device="cpu"),
           "nu": params_from_numpy(nu, device="cpu")}
    return conf, (jparams, jopt), (params, opt)


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _assert_trees_equal(a, b):
    la, lb = list(tree_leaves_with_path(a)), list(tree_leaves_with_path(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


@pytest.fixture(params=[None, 4096], ids=["whole", "chunked"])
def chunk(request, monkeypatch):
    """flax's array-chunking threshold, lowered on both sides for the
    chunked case so that the grid table and its moments are split."""
    if request.param is not None:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE",
                            request.param)
        monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", request.param)
    return request.param


@pytest.mark.parametrize("run", list(RUNS))
def test_file_is_flax_to_bytes_of_the_reference_state(run, chunk, tmp_path):
    _, (jparams, jopt), (params, opt) = _states(run)
    path = checkpoint.save_checkpoint(str(tmp_path), 3, params, opt)
    want = flax.serialization.to_bytes(
        {"params": jax.device_get(jparams), "opt_state": jax.device_get(jopt)})
    with open(path, "rb") as f:
        got = f.read()
    assert got == want
    if chunk:
        assert b"__msgpack_chunked_array__" in got


@pytest.mark.parametrize("run", list(RUNS))
def test_the_reference_reads_the_ports_file(run, chunk, tmp_path):
    _, (jparams, jopt), (params, opt) = _states(run)
    path = checkpoint.save_checkpoint(str(tmp_path), 5, params, opt,
                                      extra={"note": "port"})
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    p, s, extra = jckpt.load_checkpoint(path, zeros, jax.tree_util.tree_map(
        jnp.zeros_like, jopt))
    assert extra == {"note": "port", "step": 5}
    for a, b in zip(jax.tree_util.tree_leaves(p),
                    jax.tree_util.tree_leaves(jparams)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    assert int(s.adam.count) == 7 and s.adam.count.dtype == np.int32
    for a, b in zip(jax.tree_util.tree_leaves((s.adam.mu, s.adam.nu)),
                    jax.tree_util.tree_leaves((jopt.adam.mu, jopt.adam.nu))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("run", list(RUNS))
def test_the_port_reads_the_references_file(run, chunk, tmp_path):
    _, (jparams, jopt), (params, opt) = _states(run)
    path = jckpt.save_checkpoint(str(tmp_path), 9, jparams, jopt)
    tp, to = _zeros_like(params), {"count": 0, "mu": _zeros_like(opt["mu"]),
                                   "nu": _zeros_like(opt["nu"])}
    p, s, extra = checkpoint.load_checkpoint(path, tp, to)
    assert p is tp and s is to       # restored in place
    assert extra == {"step": 9}
    _assert_trees_equal(p, params)
    assert s["count"] == 7
    _assert_trees_equal(s["mu"], opt["mu"])
    _assert_trees_equal(s["nu"], opt["nu"])


def test_load_refuses_another_model(tmp_path):
    _, _, (params, opt) = _states("bf16")
    path = checkpoint.save_checkpoint(str(tmp_path), 0, params, opt)
    _, _, (p32, _) = _states("f32")
    with pytest.raises(ValueError, match="geometric-network/grid/F"):
        checkpoint.load_checkpoint(path, _zeros_like(p32))
    more = _zeros_like(params)
    more["extra-network"] = {"W": torch.zeros(2)}
    with pytest.raises(ValueError, match="no params/extra-network"):
        checkpoint.load_checkpoint(path, more)


def test_manifest_and_pruning_match_the_reference(tmp_path):
    _, (jparams, jopt), (params, opt) = _states("f32")
    for step in range(4):
        checkpoint.save_checkpoint(str(tmp_path / "port"), step, params, opt,
                                   keep=2)
        jckpt.save_checkpoint(str(tmp_path / "jax"), step, jparams, jopt,
                              keep=2)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "ckpt_0000002.json", "ckpt_0000002.msgpack", "ckpt_0000003.json",
        "ckpt_0000003.msgpack"]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() \
            == (tmp_path / "jax" / n).read_bytes(), n
    assert json.loads((tmp_path / "port" / names[0]).read_text()) == {
        "step": 2, "file": "ckpt_0000002.msgpack", "extra": {}}
    assert checkpoint.latest_checkpoint(str(tmp_path / "port")) \
        == str(tmp_path / "port" / "ckpt_0000003.msgpack")
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# the trainer: resume, validation
# ---------------------------------------------------------------------------

def _trainer(tmp_path, tag, extra=(), dataset=None):
    conf = load_config("default", overrides=TINY + [
        f"monitor_base_path={tmp_path}/{tag}", *extra])
    if dataset is None:
        images, masks, cameras = render_sphere_scene(n_views=4, H=16, W=16)
        dataset = IDRDataset(conf, images, masks, cameras, train=True,
                             shuffle=True)
    return Trainer(conf, dataset=dataset, device="cpu", seed=0)


@pytest.mark.parametrize("grid", ["f32", "bf16"])
def test_resume_is_bitwise_the_uninterrupted_run(tmp_path, grid):
    """2 epochs, a checkpoint, a new Trainer on the same monitor path and
    the same data stream resumes at epoch 2 and trains 1 more: params and
    optimizer state bitwise those of 3 uninterrupted epochs.  (The data
    order is the dataset's; like the JAX package, a checkpoint does not
    hold it, so the resumed trainer is handed the dataset where the first
    one left it.)"""
    extra = ["train.checkpoint_interval_epochs=2"] + (
        ["precision.grid_dtype=bfloat16", "precision.mlp_dtype=bfloat16"]
        if grid == "bf16" else [])
    ref = _trainer(tmp_path, "ref", ["valid.skip=true", *extra])
    ref.train(stop_epoch=3)
    assert ref.opt_state["count"] == 6

    first = _trainer(tmp_path, "run", ["valid.skip=true", *extra])
    first.train(stop_epoch=2)
    ckpts = os.listdir(os.path.join(first.monitor_path, "checkpoints"))
    assert sorted(ckpts) == ["ckpt_0000001.json", "ckpt_0000001.msgpack"]
    second = _trainer(tmp_path, "run", ["valid.skip=true", *extra],
                      dataset=first.ds)
    assert second.start_epoch == 2
    _assert_trees_equal(second.params, first.params)
    second.train(stop_epoch=3)
    _assert_trees_equal(second.params, ref.params)
    assert second.opt_state["count"] == ref.opt_state["count"]
    _assert_trees_equal(second.opt_state["mu"], ref.opt_state["mu"])
    _assert_trees_equal(second.opt_state["nu"], ref.opt_state["nu"])


def test_trainer_validates_and_saves_at_the_end(tmp_path):
    """``valid.skip=false``: validation at every ``epoch_interval``-th
    epoch and after the last writes the PSNR series, the rendered PNG and
    the meshes; the end of the schedule saves its checkpoint."""
    tr = _trainer(tmp_path, "val", [
        "valid.skip=false", "valid.epoch_interval=2", "valid.n_rays=16",
        "valid.n_down_samples=1", "extraction.rough_grid_size=12",
        "extraction.grid_size=14", "extraction.batch_size=1000",
        "train.epoch=3", "valid.dtumvs.pixel_margin=1"])
    tr.train()
    files = os.listdir(tr.monitor_path)
    with open(os.path.join(tr.monitor_path, "PSNR-8x8.series.txt")) as f:
        lines = f.read().splitlines()
    assert [ln.split()[0] for ln in lines] == ["2", "2"]   # epoch 2, final
    assert all(np.isfinite(float(ln.split()[1])) for ln in lines)
    pngs = os.listdir(os.path.join(tr.monitor_path, "Rendered-image-8x8"))
    assert pngs == ["000002.png"]
    assert "environment_map.png" in files
    assert "model_00002_12grid_raw_base_color_mesh00.obj" in files
    assert "model_00002_14grid_raw_base_color_mesh00.obj" in files
    assert any("_14grid_trimmed_" in f for f in files)
    assert os.listdir(os.path.join(tr.monitor_path, "checkpoints")) \
        and checkpoint.latest_checkpoint(os.path.join(
            tr.monitor_path, "checkpoints")).endswith("ckpt_0000002.msgpack")


def test_trainer_keeps_training_when_extraction_fails(tmp_path, monkeypatch):
    import ndjir_torch.train.trainer as ttrainer

    def boom(*a, **k):
        raise RuntimeError("no surface")
    monkeypatch.setattr(ttrainer, "extract_mesh_for_validation", boom)
    tr = _trainer(tmp_path, "fail", [
        "valid.skip=false", "valid.epoch_interval=1", "valid.n_rays=16",
        "valid.n_down_samples=1"])
    tr.train(stop_epoch=2)
    assert tr.start_epoch == 2
    with open(os.path.join(tr.monitor_path, "PSNR-8x8.series.txt")) as f:
        assert len(f.read().splitlines()) == 1


def test_native_init_round_trips(tmp_path):
    """The port's own model and optimizer state survive a save and a load
    into a fresh model, bitwise."""
    conf = load_config("default", overrides=RUNS["bf16"])
    params = init_model(conf, seed=3, device="cpu")
    opt = init_optimizer(params)
    opt["count"] = 11
    path = checkpoint.save_checkpoint(str(tmp_path), 0, params, opt)
    fresh = init_model(conf, seed=4, device="cpu")
    fopt = init_optimizer(fresh)
    checkpoint.load_checkpoint(path, fresh, fopt)
    _assert_trees_equal(fresh, params)
    assert fopt["count"] == 11
