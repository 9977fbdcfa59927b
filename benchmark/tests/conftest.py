"""Fixtures of the benchmark's CPU tests (``python3 -m pytest
benchmark/tests -q``).  Tests that need the card carry the ``cuda``
marker and decide in a fixture, never at import, whether there is one."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# a fixture scene: four views of 64x48
TINY_SCENE = {"views": 4, "width": 64, "height": 48, "focal_px": 60.0,
              "distance": [2.4, 3.0], "elevation_deg": [5.0, 50.0],
              "aim": 0.05, "radius": [0.3, 0.55]}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card with -m cuda)")
    return torch.device("cuda")


def tiny_config():
    """The ``tiny_test`` preset with a schedule long enough to start at
    epoch 2 and no checkpoint."""
    from ndjir_torch.config import load_config
    conf = load_config("tiny_test").to_dict()
    conf["train"]["epoch"] = 100
    conf["train"]["checkpoint_interval_epochs"] = 0
    return conf


def add_cell(root, name, config, traffic, limits, why="a fixture cell"):
    """Add a cell to the benchmark under ``root`` as new files and
    entries only: its configuration, traffic and checks files."""
    b = os.path.join(root, "benchmark")
    cname = f"{name}-conf"
    with open(os.path.join(b, "configs", f"{cname}.json"), "w") as f:
        json.dump({"name": cname, "source": "tiny_test", "reduced": [],
                   "assumed": {}, "config": config}, f)
    with open(os.path.join(b, "traffic", f"{name}.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(b, "checks", f"{name}.json"), "w") as f:
        json.dump({"limits": limits}, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": cname, "source": "tiny_test",
                             "file": f"benchmark/configs/{cname}.json",
                             "reduced": [], "why": why})
    bench["workloads"].append({"name": name, "config": cname,
                               "traffic": name, "chips": 1, "why": why})
    moves = {"train": "train_rays_per_s",
             "render": "render_rays_per_s"}[traffic["driver"]]
    if moves not in {m["name"] for m in bench["end_to_end"]}:
        # the first cell of its kind brings its rate and a per-layer metric
        bench["end_to_end"].append({"name": moves, "unit": "rays/s",
                                    "better": "higher", "bound": 0.05,
                                    "source": "host_clock",
                                    "workloads": []})
        bench["per_layer"].append({"name": "step_mfu.render", "unit": "%",
                                   "better": "higher",
                                   "source": "host_clock",
                                   "layer": "Whole view", "moves": moves,
                                   "workloads": []})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and moves in (m["name"], m.get("moves")):
            m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(bench, f)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with a tiny training cell and a tiny render
    cell added as files, held to the committed limits of the cells they
    stand in for."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    checks = os.path.join(REPO, "benchmark", "checks")
    with open(os.path.join(checks, "default-dtu49-eager.json")) as f:
        train_limits = json.load(f)["limits"]
    with open(os.path.join(checks, "default-render-val.json")) as f:
        render_limits = json.load(f)["limits"]
    add_cell(root, "tiny-train", tiny_config(),
             {"driver": "train", "steps_per_call": 1, "start_epoch": 2,
              "scene": TINY_SCENE}, train_limits)
    add_cell(root, "tiny-train-k3", tiny_config(),
             {"driver": "train", "steps_per_call": 3, "start_epoch": 2,
              "scene": dict(TINY_SCENE, views=12)}, train_limits)
    add_cell(root, "tiny-render", tiny_config(),
             {"driver": "render", "check_chunk": 256,
              "scene": dict(TINY_SCENE, views=2)}, render_limits)
    return root
