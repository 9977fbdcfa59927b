"""The benchmark's ``voxel_hash`` configuration on the CPU: the port held
against the benchmark's plain reference (``benchmark/reference/``, plain
PyTorch that imports nothing of the port) at a small size, on weights that
``benchmark.reference.weights.draw`` draws from a seed.  The hash keeps its
equations and its D=4 a level at 4 levels from G0=8 into tables of at most
2^9 rows (two of them hashed), a few hundred points, and the ``tiny_test``
networks.

Each comparison reads one gap a tensor: the largest absolute difference
over the reference's largest absolute entry.  ``TOL`` holds each
tolerance.  Both sides run the same f32 arithmetic here and read 0, and a
tolerance leaves room for a later change that sums in another order.  The
control, the port with its hash table in bf16 (8 bits of mantissa against
f32's 24), must fail every number of the query and the TV map, and the
table's gradient and update in the training step.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import counts
from benchmark import scene as scene_mod
from benchmark.reference import follow, weights
from benchmark.reference.config import Config as RefConfig
from benchmark.reference.data.batches import Batches
from benchmark.reference.ops import grid as ref_grid
from benchmark.reference.ops import tv_loss as ref_tv
from benchmark.reference.render.renderer import make_mc_cdfs as ref_mc_cdfs
from benchmark.reference.train import optim as ref_optim
from benchmark.reference.train.step import \
    loss_and_grads as ref_loss_and_grads
from ndjir_torch.config import Config, load_config
from ndjir_torch.ops import grid, tv_loss
from ndjir_torch.render.renderer import make_mc_cdfs
from ndjir_torch.train import optim
from ndjir_torch.train.trainer import loss_and_grads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)

# G_l = 8, 12, 18, 27; T_l = min(G_l^3, 2^9): 512 rows a level, levels 0
# (8^3 = 512 cells) dense in size, 1-3 hashed
HASH = {"hash_base_grid_size": 8, "hash_growth_factor": 1.5,
        "hash_table_size": 2 ** 9, "hash_levels": 4}
HASH_ARGS = (8, 1.5, 2 ** 9, 4, 4)
BOX = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
TINY_SCENE = {"views": 4, "width": 64, "height": 48, "focal_px": 60.0,
              "distance": [2.4, 3.0], "elevation_deg": [5.0, 50.0],
              "aim": 0.05, "radius": [0.3, 0.55]}

# The tolerances, each a gap as the module's docstring defines it.
TOL = {
    # the query's value, its table and point gradients, the eikonal
    # grad-of-grad: at most 8 taps a level summed in f32, so a reordered
    # sum moves a value by a few ulps of its largest term; 1e-5 is ~80
    # f32 ulps, and the bf16 table moves the values by ~2^-9 of an entry
    "query": 1e-5,
    # the TV map and its table gradient: three squared differences and a
    # square root a channel, the gradient summed over the points that
    # share a row; the same room
    "tv": 1e-5,
    # a training step's loss: a mean over B R rays of terms each summed
    # over 16 + 2 x 4 samples, a few ulps of room in the reduction order
    # (the control reads 3e-7 here: at init the N(0, 1e-3) table barely
    # moves the loss, so the table's own leaves carry the control)
    "loss": 1e-6,
    # a gradient leaf: sums over every sample of the batch (the table's
    # over up to thousands of taps a row); an order that changes the
    # float sums of the scatter moves a leaf by ~1e-6 of its largest entry
    "grad": 1e-4,
    # a leaf after one Adam step: p - lr m / (sqrt(v) + eps) with Adam's
    # first step near lr sign(g), so an update that differs only in the
    # gradient's rounding moves by far less than lr (5e-4) of the leaf's
    # largest entry
    "update": 1e-5,
}


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in f64."""
    got, want = got.detach().double(), want.detach().double()
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / scale if scale > 0 else \
        float((got - want).abs().max())


def hash_config(grid_dtype: str = "float32") -> dict:
    """``tiny_test`` with the benchmark's ``voxel_hash`` grid type at the
    small size, a schedule long enough to start at epoch 2."""
    return load_config("tiny_test", overrides=[
        "geometric_network.voxel.type=voxel_hash", "train.epoch=100",
        "train.checkpoint_interval_epochs=0",
        f"precision.grid_dtype={grid_dtype}",
        *(f"geometric_network.voxel.{k}={v}" for k, v in HASH.items())
    ]).to_dict()


@pytest.fixture(scope="module")
def drawn():
    """The drawn hash table (its leaf of the weights of seed 20), points
    in and a little outside the box, and two cotangents."""
    table = weights.draw(hash_config(), 20, "cpu")[
        "geometric-network"]["grid"]["F"]
    g = torch.Generator().manual_seed(21)
    x = (torch.rand(300, 3, generator=g) * 2.0 - 1.0) * 1.02
    cot = torch.randn(300, 4 * HASH["hash_levels"], generator=g)
    c2 = torch.randn(300, 3, generator=g)
    return table, x, cot, c2


def query_readings(query, table, x, cot, c2):
    """The query's value; d table and d x of <out, cot>; and d table and
    d x of the eikonal-style <d x, c2> (the grad-of-grad)."""
    F = table.detach().clone().requires_grad_(True)
    xr = x.detach().clone().requires_grad_(True)
    out = query(xr, F, *HASH_ARGS, *BOX)
    dF, dx = torch.autograd.grad((out.float() * cot).sum(), [F, xr],
                                 create_graph=True)
    ddF, ddx = torch.autograd.grad((dx * c2).sum(), [F, xr])
    return {"value": out, "d_table": dF, "d_x": dx, "eikonal_d_table": ddF,
            "eikonal_d_x": ddx}


def tv_readings(tv, table, x, cot, sym):
    F = table.detach().clone().requires_grad_(True)
    out = tv(x, F, *HASH_ARGS, *BOX, sym)
    (dF,) = torch.autograd.grad((out.float() * cot).sum(), [F])
    return {"value": out, "d_table": dF}


def gaps(port, ref):
    return {k: gap(port[k].float(), ref[k]) for k in ref}


CASES = [pytest.param(torch.float32, False, id="f32"),
         pytest.param(torch.bfloat16, True, id="bf16_table_control")]


@pytest.mark.parametrize("dtype,control", CASES)
def test_hash_query_against_the_reference(drawn, dtype, control):
    """The query's value, d table, d x and the eikonal grad-of-grad (d
    table and d x of a loss on d x) against the reference's; the control
    fails every one."""
    table, x, cot, c2 = drawn
    ref = query_readings(ref_grid.query_voxel_hash, table, x, cot, c2)
    port = query_readings(grid.query_voxel_hash, table.to(dtype), x, cot,
                          c2)
    got = gaps(port, ref)
    if control:
        assert min(got.values()) > TOL["query"], got
    else:
        assert max(got.values()) <= TOL["query"], got


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("dtype,control", CASES)
def test_hash_tv_against_the_reference(drawn, dtype, control, sym):
    """The hash TV map and its table gradient, with and without the
    gradient into the base corner (``sym_backward``)."""
    table, x, cot, _ = drawn
    ref = tv_readings(ref_tv.tv_loss_voxel_hash, table, x, cot, sym)
    port = tv_readings(tv_loss.tv_loss_voxel_hash, table.to(dtype), x, cot,
                       sym)
    got = gaps(port, ref)
    if control:
        assert min(got.values()) > TOL["tv"], got
    else:
        assert max(got.values()) <= TOL["tv"], got


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


def _step(conf_dict, params, batch, sched, ref: bool):
    """One step's loss, gradients and updated leaves, by the reference or
    by the port."""
    B, R = conf_dict["train"]["batch_size"], conf_dict["train"]["n_rays"]
    if ref:
        conf = RefConfig(conf_dict)
        cdfs = ref_mc_cdfs(conf, B, R, device="cpu")
        loss, _, grads = ref_loss_and_grads(params, *batch, *sched[:2], conf,
                                            cdfs)
        opt, update = ref_optim.init_optimizer(params), ref_optim.apply_updates
    else:
        conf = Config(conf_dict)
        cdfs = make_mc_cdfs(conf, B, R, device="cpu")
        loss, _, grads = loss_and_grads(params, *batch, *sched[:2], conf,
                                        cdfs=cdfs)
        opt, update = optim.init_optimizer(params), optim.apply_updates
    grads_kept = {k: g.clone() for k, g in _leaves(grads)}
    update(params, grads, opt, *sched[2:], conf)
    return loss, grads_kept, dict(_leaves(params))


@pytest.mark.parametrize("grid_dtype,control",
                         [("float32", False),
                          ("bfloat16", True)],
                         ids=["f32", "bf16_table_control"])
def test_training_step_against_the_reference(grid_dtype, control):
    """One training step of the tiny ``voxel_hash`` configuration from the
    drawn weights and one batch of the benchmark's scene: the loss, every
    gradient leaf and every leaf after the Adam update (epoch 2's learning
    rates).  The control, the port's table in bf16, fails the table's
    gradient and its update."""
    conf = hash_config()
    scene = scene_mod.make_scene(TINY_SCENE, 22, "cpu")
    batch = [torch.from_numpy(a) for a in Batches(
        *scene, conf["train"]["n_rays"], np.random.RandomState(23)).next(
        conf["train"]["batch_size"])]
    sched = follow.epoch_scalars(RefConfig(conf), 2, "cpu")
    ref = _step(conf, weights.draw(conf, 24, "cpu"), batch, sched, True)

    port_conf = hash_config(grid_dtype)
    params = weights.draw(conf, 24, "cpu")
    grid_leaf = params["geometric-network"]["grid"]
    grid_leaf["F"] = grid_leaf["F"].to(getattr(torch, grid_dtype))
    port = _step(port_conf, params, batch, sched, False)

    loss_gap = gap(port[0].reshape(1), ref[0].reshape(1))
    grad_gaps = {k: gap(g.float(), ref[1][k]) for k, g in port[1].items()}
    update_gaps = {k: gap(p.float(), ref[2][k]) for k, p in port[2].items()}
    assert port[1].keys() == ref[1].keys() == port[2].keys()
    table = "geometric-network/grid/F"
    if control:
        assert grad_gaps[table] > TOL["grad"], grad_gaps[table]
        assert update_gaps[table] > TOL["update"], update_gaps[table]
    else:
        assert loss_gap <= TOL["loss"], loss_gap
        assert max(grad_gaps.values()) <= TOL["grad"], grad_gaps
        assert max(update_gaps.values()) <= TOL["update"], update_gaps


def test_benchmark_configuration_is_the_preset_at_published_widths():
    """``benchmark/configs/voxel_hash.json`` is the port's ``voxel_hash``
    preset, nothing cut: the op's hash keys (G0 16, growth 1.5, 2^15 rows,
    16 levels) at default.yaml's D=4, 476,672 rows in all, and an SDF MLP
    whose first layer takes 39 + 64 inputs."""
    with open(os.path.join(REPO, "benchmark", "configs",
                           "voxel_hash.json")) as f:
        c = json.load(f)
    assert c["config"] == load_config(c["program_config"]).to_dict()
    assert c["reduced"] == [] and c["overrides"] == []
    v = c["config"]["geometric_network"]["voxel"]
    assert (v["type"], v["hash_base_grid_size"], v["hash_growth_factor"],
            v["hash_table_size"], v["hash_levels"], v["feature_size"]) \
        == ("voxel_hash", 16, 1.5, 2 ** 15, 16, 4)
    assert grid.hash_num_params(16, 1.5, 2 ** 15, 16, 4) == 476_672 * 4
    assert counts.geometric_layers(c["config"])[0] == (103, 256)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        entry = {x["name"]: x for x in json.load(f)["configs"]}["voxel_hash"]
    assert entry["file"] == "benchmark/configs/voxel_hash.json"
    assert entry["source"] == c["source"] and entry["reduced"] == []
