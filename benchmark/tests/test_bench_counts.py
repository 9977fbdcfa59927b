"""The FLOP and byte counters against counts made by hand."""

import json
import os

import pytest

from benchmark import counts
from conftest import REPO, tiny_config


def test_tiny_test_layers_by_hand():
    c = tiny_config()
    # SDF net: 3 + 36 PE + 4 grid = 43 in, 64 wide, skip at layer 2:
    # layer 1 narrows to 64 - 43 = 21 and the inputs are concatenated back
    assert counts.geometric_layers(c) == [(43, 64), (64, 21), (64, 64),
                                          (64, 65)]
    h = counts.head_layers(c)
    assert h["base_color"] == [(67, 16), (16, 3)]
    assert h["env"] == [(39, 16), (16, 1)]
    assert h["soft_vis"] == [(109, 16), (16, 1)]
    assert h["implicit"] == [(70, 16), (16, 1)]
    assert h["photo"] == [(98, 16), (16, 1)]
    assert h["rough"] == [(70, 16), (16, 2)]
    assert h["spec"] == [(70, 16), (16, 6)]
    assert h["bg_geo"] == [(52, 16), (16, 16), (16, 16), (16, 17)]
    assert h["bg_light"] == [(50, 16), (16, 3)]


def test_tiny_test_step_and_ray_by_hand():
    c = tiny_config()
    geo = 2 * (43 * 64 + 64 * 21 + 64 * 64 + 64 * 65)          # 24,704
    bc = 2 * (67 * 16 + 16 * 3)
    heads = 2 * (70 * 16 + 16) + 2 * (98 * 16 + 16) \
        + 2 * (70 * 16 + 32) + 2 * (70 * 16 + 96)
    env, env_first = 2 * (39 * 16 + 16), 2 * 39 * 16
    bg, bg_first = 2 * (52 * 16 + 16 * 16 * 2 + 16 * 17), 2 * 52 * 16
    bgl = 2 * (50 * 16 + 16 * 3)
    rays, n, n_prop, nb, M = 64, 16, 12, 4, 8
    sv_pixel, sv_dir = 2 * rays * 70 * 16, 2 * rays * M * 39 * 16
    sv = sv_pixel + sv_dir + rays * M * 2 * 16
    train = rays * (n_prop * geo + 6 * n * geo + 3 * n * geo
                    + 3 * 2 * n * bc + 3 * n * heads) \
        + 2 * (rays * M * (3 * env - env_first) + 3 * sv - sv_dir) \
        + rays * nb * (3 * bg - bg_first) + 3 * rays * nb * bgl
    assert counts.train_step_flops(c) == train
    sv1 = 2 * 70 * 16 + 2 * M * 39 * 16 + M * 2 * 16
    ray = n_prop * geo + 2 * n * geo + n * geo + 2 * n * bc + n * heads \
        + 2 * (M * env + sv1) + nb * (bg + bgl)
    assert counts.render_ray_flops(c) == ray


def test_layers_match_the_weights_drawn():
    """The counter's widths are the shapes of the weights the benchmark
    draws (the grid cut to 8^3 here: it sets no width)."""
    from benchmark.reference.weights import draw
    with open(os.path.join(REPO, "benchmark", "configs", "custom.json")) as f:
        c = json.load(f)["config"]
    c["geometric_network"]["voxel"]["grid_size"] = 8
    w = draw(c, 0, "cpu")
    geo = w["geometric-network"]
    names = sorted(k for k in geo if k.startswith("affine"))
    got = [tuple(geo[k]["W"].shape) for k in names]
    assert got == counts.geometric_layers(c)
    bc = w["base-color-network"]
    assert [tuple(bc[k]["W"].shape) for k in sorted(bc)] \
        == counts.head_layers(c)["base_color"]


def test_remat_is_refused():
    c = tiny_config()
    c["train"]["remat_heads"] = True
    with pytest.raises(ValueError):
        counts.train_step_flops(c)


def test_scatter_bytes_by_hand():
    # the default step's scatter: 2,097,152 updates of 4 f32 values with
    # int64 ids into the 512^3-row table: 0.6561 ms at 3.35 TB/s
    n, rows = 8 * 2048 * 128, 512 ** 3
    b = counts.scatter_bytes(n, 4, rows, 8, 4)
    assert b == n * 8 + n * 16 + rows * 16
    assert abs(1e3 * b / 3.35e12 - 0.6561) < 1e-4


def test_card_peaks():
    p = counts.card_peaks("NVIDIA H100 80GB HBM3")
    assert p == {"bytes_per_s": 3.35e12, "float32": 67e12,
                 "bfloat16": 989e12}
    assert counts.card_peaks("NVIDIA H100 PCIe")["float32"] == 51e12
    with pytest.raises(ValueError):
        counts.card_peaks("cpu")
