"""Every file the benchmark names loads and keeps to the contract's shape,
and a cell added as new files runs through the harness unchanged."""

import argparse
import json
import os
import re
import time

import pytest

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
    assert all(w["chips"] == 1 for w in b["workloads"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_finds_its_files(cell):
    from benchmark import harness
    c = harness.Cell(bench(), cell)
    assert os.path.exists(c.driver_path)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert os.path.exists(os.path.join(
            c.metric_dir, f"{harness.quantity(m['name'])}.py"))
    assert set(c.limits) == ({"first_loss_gap", "loss_gap",
                              "moment_gap_median", "moment_gap",
                              "change_gap_median", "change_gap"}
                             if c.traffic["driver"] == "train"
                             else {"color_gap", "normal_gap"})
    for entry in c.limits.values():
        assert entry["limit"] > 0 and entry["readings"]
        assert entry["lower"] < entry["limit"] < entry["upper"]


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_end_to_end_metric_is_measured(cell):
    """Each end-to-end metric of a cell names a quantity its window, or
    the harness, measures."""
    from benchmark import harness
    c = harness.Cell(bench(), cell)
    rate = {"train": "train_rays_per_s",
            "render": "render_rays_per_s"}[c.traffic["driver"]]
    for m in c.end_to_end:
        assert harness.quantity(m["name"]) in {rate, "setup_s",
                                                "peak_mem_gib"}


def test_a_variant_metric_reports_the_window_quantity(tiny_root):
    """A cell given its own ``train_rays_per_s.<variant>`` reports it, and
    its ``host_batch_ms.<variant>`` is read by ``host_batch_ms.py``."""
    from benchmark import harness
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    for m in b["end_to_end"]:
        if m["name"] == "train_rays_per_s":
            m["workloads"].remove("tiny-train")
    b["end_to_end"].append({"name": "train_rays_per_s.tiny",
                            "unit": "rays/s", "better": "higher",
                            "bound": 0.1, "source": "host_clock",
                            "workloads": ["tiny-train"]})
    for m in b["per_layer"]:
        if "tiny-train" in m.get("workloads", []):
            m["workloads"].remove("tiny-train")
    b["per_layer"].append({"name": "host_batch_ms.tiny", "unit": "ms/step",
                           "better": "lower", "source": "host_clock",
                           "layer": "Trainer loop (host)",
                           "moves": "train_rays_per_s.tiny",
                           "workloads": ["tiny-train"]})
    with open(path, "w") as f:
        json.dump(b, f)
    args = argparse.Namespace(workload="tiny-train", seed=3, seconds=0.3,
                              trace=0)
    out = harness.run(args, time.perf_counter(), require_card=False,
                      device="cpu", root=tiny_root)
    assert out["metrics"]["train_rays_per_s.tiny"]["value"] > 0
    assert "train_rays_per_s" not in out["metrics"]
    args.trace = 1
    out = harness.run(args, time.perf_counter(), require_card=False,
                      device="cpu", root=tiny_root)
    assert set(out["metrics"]) == {"host_batch_ms.tiny"}


@pytest.mark.parametrize("name", ["default", "custom"])
def test_configuration_files_hold_the_presets_as_published(name):
    """The configuration as run is the port's preset, nothing cut."""
    from ndjir_torch.config import load_config
    with open(os.path.join(REPO, "benchmark", "configs",
                           f"{name}.json")) as f:
        c = json.load(f)
    assert c["config"] == load_config(c["program_config"]).to_dict()
    assert c["reduced"] == [] and c["overrides"] == []
    entry = {x["name"]: x for x in bench()["configs"]}[name]
    assert entry["file"] == f"benchmark/configs/{name}.json"
    assert entry["source"] == c["source"] and len(c["source"]) <= 200


def test_metric_readers_load():
    from benchmark import harness
    for m in bench()["per_layer"]:
        q = harness.quantity(m["name"])
        mod = harness.load_module(os.path.join(
            REPO, "benchmark", "metrics", f"{q}.py"), q)
        assert callable(mod.read)


def test_each_cell_has_a_rate_of_its_own():
    """Each cell's rate carries its own bound, and each cell reports every
    per-layer quantity under a name that moves that rate."""
    b = bench()
    rates = [m for m in b["end_to_end"]
             if m["name"] not in ("setup_s", "peak_mem_gib")]
    assert sorted(c for m in rates for c in m["workloads"]) \
        == sorted(w["name"] for w in b["workloads"])
    for m in rates:
        pl = [p for p in b["per_layer"] if p["moves"] == m["name"]]
        assert {p["workloads"] == m["workloads"] for p in pl} == {True}
        readers = [f for f in os.listdir(os.path.join(
            REPO, "benchmark", "metrics")) if f.endswith(".py")]
        assert len(pl) == len(readers)


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-train-k3",
                                  "tiny-render"])
def test_a_cell_added_as_files_runs(tiny_root, cell):
    """Cells added to a copy of the benchmark as files and entries run
    through the harness on the CPU, correct against their reference."""
    from benchmark import harness
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 77,
                              seconds=0.5, trace=0)
    out = harness.run(args, time.perf_counter(), require_card=False,
                      device="cpu", root=tiny_root)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"]


def test_traced_run_reports_the_host_span(tiny_root):
    from benchmark import harness
    args = argparse.Namespace(workload="tiny-train", seed=5, seconds=0.5,
                              trace=1)
    out = harness.run(args, time.perf_counter(), require_card=False,
                      device="cpu", root=tiny_root)
    assert out["metrics"]["host_batch_ms.train"]["value"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


def test_an_unknown_cell_is_refused(tiny_root):
    from benchmark import harness
    with pytest.raises(harness.Refused):
        harness.Cell(bench(), "no-such-cell")
