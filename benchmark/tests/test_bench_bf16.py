"""The production-precision configuration (``configs/bf16.json``) and its
cell ``bf16-dtu49-k8``: the configuration is the port's ``bf16`` preset
with its two overrides, the plain reference follows the port's step on
that path (a bf16 grid in the octa layout, bf16 MLP operands) on the CPU
at ``tiny_test`` widths, the cell reports every reader under the k8
cell's rate, the bf16-sum control rounds what the configuration does not, and
the cell's limits refuse every recorded control and reorder."""

import argparse
import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import scene as scene_mod
from benchmark.reference import follow, weights
from benchmark.reference.config import Config as RefConfig
from benchmark.reference.data.batches import Batches
from conftest import REPO, TINY_SCENE, add_cell, tiny_config

CELL = "bf16-dtu49-k8"
OVERRIDES = ["geometric_network.voxel.grid_size=256",
             "precision.grid_dtype=bfloat16"]
REDUCED = "geometric_network.voxel.grid_size"


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_configuration_is_the_bf16_preset_with_its_overrides():
    """The preset with its two overrides; the grid, cut from the published
    512 to 256 by the first of them, is the one key in ``reduced``."""
    from ndjir_torch.config import load_config
    with open(os.path.join(REPO, "benchmark", "configs", "bf16.json")) as f:
        c = json.load(f)
    assert c["program_config"] == "bf16" and c["overrides"] == OVERRIDES
    assert c["config"] == load_config("bf16", OVERRIDES).to_dict()
    assert c["reduced"] == [REDUCED]
    published = load_config("bf16").to_dict()
    assert published["geometric_network"]["voxel"]["grid_size"] == 512
    assert c["config"]["geometric_network"]["voxel"]["grid_size"] == 256
    assert c["config"]["precision"] == {"mlp_dtype": "bfloat16",
                                        "grid_dtype": "bfloat16"}
    entry = {x["name"]: x for x in bench()["configs"]}["bf16"]
    assert entry["file"] == "benchmark/configs/bf16.json"
    assert entry["reduced"] == [REDUCED]
    assert entry["source"] == c["source"] and len(c["source"]) <= 200


def test_the_cell_takes_the_octa_layout():
    """At the configuration's G=256 the bf16 rows fit the octa budget; at
    the published G=512 they would not."""
    from ndjir_torch.ops.grid import use_octa_layout
    with open(os.path.join(REPO, "benchmark", "configs", "bf16.json")) as f:
        v = json.load(f)["config"]["geometric_network"]["voxel"]
    G, D = v["grid_size"], v["feature_size"]
    assert use_octa_layout((G, G, G, D), torch.bfloat16)
    assert not use_octa_layout((512, 512, 512, D), torch.bfloat16)
    cell = {w["name"]: w for w in bench()["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) \
        == ("bf16", "dtu49-k8", 1)


def test_the_cell_reports_every_reader_under_the_k8_rate():
    """The cell shares ``train_rays_per_s`` (bound 0.03) with the k8 cell
    whose traffic and captured call it runs, and with it every reader's
    ``.train`` metric: the list of each metric only gained the cell."""
    b = bench()
    (rate,) = [m for m in b["end_to_end"] if CELL in m.get("workloads", [])]
    assert rate["name"] == "train_rays_per_s" and rate["bound"] == 0.03
    assert rate["workloads"] == ["default-dtu49-k8", CELL]
    readers = {f[:-3] for f in os.listdir(os.path.join(
        REPO, "benchmark", "metrics")) if f.endswith(".py")}
    mine = [m for m in b["per_layer"] if CELL in m.get("workloads", [])]
    assert {m["name"] for m in mine} == {f"{q}.train" for q in readers}
    assert len(mine) == len(readers)
    for m in mine:
        assert m["workloads"] == ["default-dtu49-k8", CELL]
        assert m["moves"] == "train_rays_per_s"


def check_limits():
    with open(os.path.join(REPO, "benchmark", "checks",
                           f"{CELL}.json")) as f:
        return json.load(f)["limits"]


@pytest.mark.parametrize("reading", ["control", "f32_order", "bf16_sum",
                                     "half_batch"])
def test_the_limits_refuse_every_recorded_control_and_reorder(reading):
    """Each limit lies above the geometric mean of the sound maximum and
    the upper control reading, so every sound reading passes, while the
    TF32 control, the sound program in another order and the bf16-sum
    control each fail at least one limit on every seed it was read on,
    and the half batch fails all six."""
    limits = check_limits()
    for v in limits.values():
        sound = [x for name in ("program", "fresh_runs", "reference_again")
                 for x in v["readings"][name]]
        assert max(sound) == v["lower"]
        assert v["upper"] == min(v["readings"][v["upper_from"]])
        assert v["limit"] > (v["lower"] * v["upper"]) ** 0.5
    (n,) = {len(v["readings"][reading]) for v in limits.values()}
    assert n >= 8
    for i in range(n):
        failed = [k for k, v in limits.items()
                  if v["readings"][reading][i] > v["limit"]]
        assert failed, (reading, i)
        if reading == "half_batch":
            assert len(failed) == len(limits)


def bf16_tiny():
    conf = tiny_config()
    conf["precision"].update(mlp_dtype="bfloat16", grid_dtype="bfloat16")
    conf["renderer"]["proposal_grid_bf16"] = True
    return conf


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    return bf16_tiny(), scene_mod.make_scene(TINY_SCENE, 11, "cpu")


def test_training_step_is_the_ports_at_the_production_precision(tiny):
    """Three steps at bf16 operands over a bf16 grid in the octa layout,
    from the same weights and draws: losses, first moments and changes
    bitwise as the port's plain path computes them."""
    from ndjir_torch.config import Config
    from ndjir_torch.models.fields import geometric_supports_shared_gather
    from ndjir_torch.render.renderer import make_mc_cdfs
    from ndjir_torch.train.optim import init_optimizer
    from ndjir_torch.train.trainer import train_step
    conf, scene = tiny
    c = Config(conf)
    params = weights.draw(conf, 3, "cpu")
    assert params["geometric-network"]["grid"]["F"].dtype == torch.bfloat16
    assert geometric_supports_shared_gather(params["geometric-network"], c)
    ref = follow.train_epoch(conf, scene, {"weights": 3, "data": 4},
                             {"start_epoch": 2}, 3, "cpu")

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
        assert float(torch.linalg.vector_norm((p - p0[k]).float())) \
            == ref["changes"]["/".join(k)]


def test_the_controls_products_and_their_undoing():
    """``bf16_sum`` rounds each product's sums to bf16; ``f32_order`` keeps
    the configuration's exact products and f32 sums; both leave f32
    layers alone and are undone at the block's end."""
    from benchmark.control_bf16 import products
    from benchmark.reference.models import fields
    g = torch.Generator().manual_seed(1)
    h = torch.randn(64, 256, generator=g)
    W = torch.randn(256, 32, generator=g)
    exact = fields._matmul(h, W, torch.bfloat16)
    assert not torch.equal(exact, exact.to(torch.bfloat16).float())
    with products("bf16_sum"):
        rounded = fields._matmul(h, W, torch.bfloat16)
        assert torch.equal(fields._matmul(h, W, None), h @ W)
    assert rounded.dtype == torch.float32
    assert torch.equal(rounded, rounded.to(torch.bfloat16).float())
    assert (rounded - exact).abs().max() <= 2 ** -8 * exact.abs().max()
    with products("f32_order"):
        assert torch.equal(fields._matmul(h, W, torch.bfloat16), exact)
        assert torch.equal(fields._matmul(h, W, None), h @ W)
    assert torch.equal(fields._matmul(h, W, torch.bfloat16), exact)
    assert fields._matmul.__name__ == "_matmul"


def test_a_tiny_bf16_cell_runs_correct_at_the_cells_limits(tiny_root):
    """The cell's driver, traffic grouping and limits on a tiny bf16-octa
    configuration added as files: the harness's run on the CPU, three
    steps a call, correct against the reference."""
    from benchmark import harness
    limits = check_limits()
    add_cell(tiny_root, "tiny-bf16-k3", bf16_tiny(),
             {"driver": "train", "steps_per_call": 3, "start_epoch": 2,
              "scene": dict(TINY_SCENE, views=12)}, limits)
    args = argparse.Namespace(workload="tiny-bf16-k3", seed=2 ** 31 + 16,
                              seconds=0.5, trace=0)
    out = harness.run(args, time.perf_counter(), require_card=False,
                      device="cpu", root=tiny_root)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(c["value"] == 0.0 for c in out["checks"].values())
