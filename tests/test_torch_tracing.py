"""The port's spans (``ndjir_torch/utils/profiling.py``): off and shared
outside a profiler; under one, nested spans with their parent, step and
counts on the profiler's clock; the trainer's loop and step recorded per
epoch, eagerly and in calls of two steps; the octa grid's gather, backward
and table build at the production precision; the hash grid's queries and
TV map; the Chrome trace of ``profiling.trace()`` holding them (CPU,
``tiny_test`` widths)."""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ndjir_torch.config import load_config
from ndjir_torch.data.dataset import IDRDataset
from ndjir_torch.data.synthetic import render_sphere_scene
from ndjir_torch.train.trainer import Trainer
from ndjir_torch.utils import profiling
from ndjir_torch.utils.profiling import annotate, set_step

torch.set_num_threads(2)

STEP_PHASES = ["step.sample", "step.render", "step.loss", "step.backward",
               "step.update"]


@pytest.fixture(autouse=True)
def no_spans(monkeypatch):
    monkeypatch.setattr(profiling, "_SPANS", [])
    monkeypatch.setattr(profiling, "_STEP", [None])


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_outside_a_profiler():
    """No profiler: one shared no-op, nothing recorded."""
    assert not torch.autograd._profiler_enabled()
    a, b = annotate("train.step", steps=1), annotate("other")
    assert a is b
    with a:
        with b:
            torch.ones(4).sum()
    assert profiling.spans() == []


def test_nested_spans_carry_parent_step_and_counts():
    with cpu_profile():
        set_step(7)
        with annotate("outer", steps=3):
            with annotate("inner"):
                torch.ones(4).sum()
            set_step(8)
            with annotate("second", steps=1):
                pass
        with annotate("after"):
            pass
    inner, second, outer, after = profiling.spans()
    assert [s.name for s in (inner, second, outer, after)] \
        == ["inner", "second", "outer", "after"]
    assert outer.parent_id is None and after.parent_id is None
    assert inner.parent_id == second.parent_id == outer.span_id
    assert (outer.step, inner.step, second.step) == (7, 7, 8)
    assert outer.counts == {"steps": 3} and inner.counts == {}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns \
        <= second.start_ns <= second.end_ns <= outer.end_ns
    assert len({s.span_id for s in profiling.spans()}) == 4


def test_an_op_inside_a_span_lies_within_it():
    """The profiler's event of an operator run inside a span lies within
    the span's [start_ns, end_ns]: one clock."""
    a = torch.randn(64, 64)
    with cpu_profile() as prof:
        with annotate("matmul"):
            a @ a
    (s,) = profiling.spans()
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert s.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s.end_ns


def _trainer(tmp_path, spc, extra=()):
    conf = load_config("tiny_test", overrides=[
        "valid.skip=true", "data_path=synthetic/sphere", "train.epoch=3",
        "train.n_rays=16", "train.checkpoint_interval_epochs=0",
        f"train.steps_per_call={spc}",
        f"monitor_base_path={tmp_path}/spc{spc}", *extra])
    images, masks, cameras = render_sphere_scene(n_views=8, H=16, W=16)
    ds = IDRDataset(conf, images, masks, cameras, train=True, shuffle=True)
    return Trainer(conf, dataset=ds, device="cpu", seed=0)


@pytest.mark.parametrize("spc", [1, 2])
def test_trainer_records_the_loop_and_step_spans(tmp_path, spc):
    """One epoch under the profiler: one ``train.epoch`` root holding the
    schedule, the batches, the steps (eager ``train.step``, or
    ``train.call`` of two steps), the fetch and the monitors; each step's
    five phases under the span that ran it; the ``steps`` counts add up
    to the epoch's steps, and each span carries its global step."""
    tr = _trainer(tmp_path, spc)
    iters = tr.ds.iters_per_epoch
    assert iters == 4
    tr.train(stop_epoch=1)
    with cpu_profile():
        tr.train(stop_epoch=2)
    spans = profiling.spans()
    by_id = {s.span_id: s for s in spans}
    (epoch,) = [s for s in spans if s.name == "train.epoch"]
    assert epoch.parent_id is None and epoch.step == iters
    outer = "train.step" if spc == 1 else "train.call"
    top = [s.name for s in spans if s.parent_id == epoch.span_id]
    assert sorted(set(top)) == sorted({"train.schedule", "train.batch",
                                       outer, "train.fetch",
                                       "train.monitors"})
    calls = [s for s in spans if s.name == outer]
    batches = [s for s in spans if s.name == "train.batch"]
    assert len(calls) == len(batches) == iters // spc
    assert sum(s.counts["steps"] for s in calls) == iters
    assert sum(s.counts["steps"] for s in batches) == iters
    assert len(tr.history) == 2 * iters
    assert [s.step for s in calls] == list(range(iters, 2 * iters, spc))
    for s in calls:
        phases = [c.name for c in spans if c.parent_id == s.span_id]
        assert phases == STEP_PHASES * spc
        assert epoch.start_ns <= s.start_ns <= s.end_ns <= epoch.end_ns
    for s in spans:
        if s is not epoch:
            assert s.parent_id in by_id
    assert all(s.end_ns >= s.start_ns for s in spans)


def test_trainer_outside_a_profiler_records_nothing(tmp_path):
    tr = _trainer(tmp_path, 1)
    tr.train(stop_epoch=1)
    assert profiling.spans() == [] and len(tr.history) == 4


BF16 = ("precision.mlp_dtype=bfloat16", "precision.grid_dtype=bfloat16")


def test_octa_grid_spans_at_the_production_precision(tmp_path):
    """A bf16 grid in the octa layout, eager steps: outside a profiler
    nothing is recorded; under one, each step records one
    ``grid.octa_gather`` in ``step.render`` (x_fg and x_ptb in one
    gather) and one ``grid.octa_backward`` (B1 then B2) in
    ``step.backward``, both with the rows B R N x 2, and the proposal
    sampler's no-grad gathers in ``step.sample``, B R n0 rows and then
    B R n1 a round; ``with_octa_table`` records one ``grid.octa_build``
    with the table's G^3 rows."""
    from ndjir_torch.models.fields import (
        geometric_supports_shared_gather,
        with_octa_table,
    )
    tr = _trainer(tmp_path, 1, BF16)
    c = tr.conf
    assert geometric_supports_shared_gather(
        tr.params["geometric-network"], c)
    tr.train(stop_epoch=1)
    assert profiling.spans() == []
    with cpu_profile():
        tr.train(stop_epoch=2)
    spans = profiling.spans()
    by_id = {s.span_id: s for s in spans}
    rays = c.train.batch_size * c.train.n_rays
    r = c.renderer
    n = r.n_samples0 + r.n_upsamples * r.n_samples1
    proposal = [rays * r.n_samples0] \
        + [rays * r.n_samples1] * (r.n_upsamples - 1)
    steps = list(range(tr.ds.iters_per_epoch, 2 * tr.ds.iters_per_epoch))
    for step in steps:
        mine = [(s.name, by_id[s.parent_id].name, s.counts) for s in spans
                if s.step == step and s.name.startswith("grid.")]
        assert mine == [("grid.octa_gather", "step.sample", {"rows": k})
                        for k in proposal] + [
            ("grid.octa_gather", "step.render", {"rows": 2 * rays * n}),
            ("grid.octa_backward", "step.backward", {"rows": 2 * rays * n})]
    G = c.geometric_network.voxel.grid_size
    with_octa_table(tr.params, c)
    assert not any(s.name == "grid.octa_build" for s in profiling.spans())
    with cpu_profile():
        with_octa_table(tr.params, c)
    (build,) = [s for s in profiling.spans() if s.name == "grid.octa_build"]
    assert build.counts == {"rows": G ** 3}


HASH = ("geometric_network.voxel.type=voxel_hash",
        "geometric_network.voxel.hash_base_grid_size=8",
        "geometric_network.voxel.hash_table_size=512",
        "geometric_network.voxel.hash_levels=4")


@pytest.mark.parametrize("grid_type", ["voxel_hash", "voxel"])
def test_hash_grid_spans(tmp_path, grid_type):
    """Eager steps under the profiler: a ``voxel_hash`` step records in
    ``step.render`` two ``grid.hash_query`` spans (x_ptb, then x_fg), each
    of B R N points, L levels and 8 L rows a point, then one
    ``grid.hash_tv`` of the x_fg points with 4 L rows a point; the
    proposal sampler's no-grad queries in ``step.sample``, B R n0 points
    and then B R n1 a round.  A dense voxel's step records none."""
    tr = _trainer(tmp_path, 1, HASH if grid_type == "voxel_hash" else ())
    tr.train(stop_epoch=1)
    assert profiling.spans() == []
    with cpu_profile():
        tr.train(stop_epoch=2)
    spans = profiling.spans()
    by_id = {s.span_id: s for s in spans}
    c = tr.conf
    L = c.geometric_network.voxel.hash_levels
    rays = c.train.batch_size * c.train.n_rays
    r = c.renderer
    n = r.n_samples0 + r.n_upsamples * r.n_samples1
    proposal = [rays * r.n_samples0] \
        + [rays * r.n_samples1] * (r.n_upsamples - 1)

    def query(points):
        return {"points": points, "levels": L, "rows": points * 8 * L}

    steps = list(range(tr.ds.iters_per_epoch, 2 * tr.ds.iters_per_epoch))
    for step in steps:
        mine = [(s.name, by_id[s.parent_id].name, s.counts) for s in spans
                if s.step == step and s.name.startswith("grid.hash")]
        if grid_type == "voxel":
            assert mine == []
            continue
        assert mine == [("grid.hash_query", "step.sample", query(k))
                        for k in proposal] + [
            ("grid.hash_query", "step.render", query(rays * n)),
            ("grid.hash_query", "step.render", query(rays * n)),
            ("grid.hash_tv", "step.render",
             {"points": rays * n, "levels": L, "rows": rays * n * 4 * L})]


def test_chrome_trace_holds_the_spans(tmp_path):
    """``trace()`` clears the spans on entry and its Chrome trace shows
    every span by name."""
    tr = _trainer(tmp_path, 1)
    with cpu_profile():
        with annotate("before"):
            pass
    assert [s.name for s in profiling.spans()] == ["before"]
    with profiling.trace(str(tmp_path / "tr")) as logdir:
        tr.train(stop_epoch=1)
    names = {s.name for s in profiling.spans()}
    assert "before" not in names
    assert {"train.epoch", "train.step", "train.batch"} | set(STEP_PHASES) \
        <= names
    with open(os.path.join(logdir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert names <= {e.get("name") for e in events}
