"""The readers of the program's own spans (``benchmark.program_spans``):
host ms a step in named spans, the idle share under a step's spans, idle
time by innermost program span; None where the program records no spans
or its ``steps`` counts disagree with the window's steps; and a traced
fixture run on the CPU that reports them."""

import argparse
import time
import types

import pytest

from benchmark import program_spans, trace


def span(name, t0, t1, sid, parent=None, **counts):
    from ndjir_torch.utils.profiling import Span
    return Span(name, int(t0 * 1e9), int(t1 * 1e9), sid, parent, None,
                counts)


# two eager steps: the device idles 2.5 -> 3.0 in step.render, 3.5 -> 6.0
# in the second train.batch, 7.0 -> 7.5 in the fetch
SPANS = [span("train.epoch", 0.5, 7.9, 1),
         span("train.batch", 0.6, 0.9, 2, 1, steps=1),
         span("train.step", 1.0, 3.2, 3, 1, steps=1),
         span("step.render", 2.0, 3.1, 4, 3),
         span("train.batch", 3.3, 6.5, 5, 1, steps=1),
         span("train.step", 6.6, 6.9, 6, 1, steps=1),
         span("train.fetch", 6.95, 7.8, 7, 1)]


def a_run(monkeypatch, spans=SPANS, steps=2, kernels=None):
    from ndjir_torch.utils import profiling

    monkeypatch.setattr(profiling, "_SPANS", list(spans))
    kernels = kernels if kernels is not None else [
        ("gemm", 1.0, 2.5), ("index_kernel", 3.0, 3.5), ("gemm", 6.0, 7.0),
        ("gemm", 7.5, 7.9)]
    t = trace.Trace(kernels, [("cudaDeviceSynchronize", 7.8, 8.0)],
                    window_s=8.0)
    window = {"kind": "train", "attempted": steps, "rays": steps * 2048,
              "conf": {"precision": {"mlp_dtype": "float32"}}}
    return trace.TraceRun(t, window, types.SimpleNamespace(host_ms={}),
                          "NVIDIA H100 80GB HBM3")


def test_host_ms_a_step_in_named_spans(monkeypatch):
    run = a_run(monkeypatch)
    assert program_spans.host_ms_per_step(run, ("train.batch",)) \
        == pytest.approx(1e3 * (0.3 + 3.2) / 2)
    assert program_spans.host_ms_per_step(run, program_spans.STEP_SPANS) \
        == pytest.approx(1e3 * (2.2 + 0.3) / 2)


def test_idle_share_under_the_steps_spans(monkeypatch):
    # only the gap that began in step.render, a child of train.step
    run = a_run(monkeypatch)
    assert program_spans.idle_step_share(run) == pytest.approx(
        100.0 * 0.5 / 8.0)


def test_idle_by_span_adds_up_to_the_idle_time(monkeypatch):
    run = a_run(monkeypatch)
    idle = program_spans.idle_by_span(run)
    assert idle == pytest.approx({"step.render": 0.5, "train.batch": 2.5,
                                  "train.fetch": 0.5,
                                  program_spans.EDGES: 1.1})
    assert sum(idle.values()) == pytest.approx(8.0 - run.trace.busy_s)


def test_a_gap_outside_every_span_is_named_so(monkeypatch):
    run = a_run(monkeypatch, spans=[span("train.step", 0.0, 0.6, 1,
                                         steps=1)], steps=1,
                kernels=[("gemm", 0.5, 0.7), ("gemm", 2.0, 3.0)])
    assert program_spans.idle_by_span(run)[program_spans.OUTSIDE] \
        == pytest.approx(1.3)
    assert program_spans.idle_step_share(run) == 0.0


@pytest.mark.parametrize("metric", ["batch_ms", "step_host_ms",
                                    "idle_step_share"])
def test_none_where_the_programs_steps_disagree(monkeypatch, metric):
    from benchmark import harness
    reader = harness.load_module(
        f"{harness.HERE}/metrics/{metric}.py", f"m_{metric}")
    assert reader.read(a_run(monkeypatch, steps=2)) is not None
    assert reader.read(a_run(monkeypatch, steps=3)) is None
    # spans of an earlier window, outside this one, count for nothing
    early = [s._replace(start_ns=s.start_ns - 10 ** 11,
                        end_ns=s.end_ns - 10 ** 11) for s in SPANS]
    assert reader.read(a_run(monkeypatch, spans=early)) is None


@pytest.mark.parametrize("metric", ["batch_ms", "step_host_ms",
                                    "idle_step_share"])
def test_none_for_a_program_without_spans(monkeypatch, metric):
    """The parent of the change that added the spans has no ``spans()``:
    its traced run leaves these metrics out and raises nothing."""
    from benchmark import harness
    from ndjir_torch.utils import profiling
    reader = harness.load_module(
        f"{harness.HERE}/metrics/{metric}.py", f"m_{metric}")
    run = a_run(monkeypatch)
    monkeypatch.delattr(profiling, "spans")
    assert reader.read(run) is None


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-train-k3"])
def test_traced_run_reports_the_program_spans(tiny_root, cell):
    """A traced fixture run on the CPU (the profiler's host operators, no
    kernels) reports the two host readings and no idle share."""
    from benchmark import harness
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 5, seconds=0.5,
                              trace=1)
    out = harness.run(args, time.perf_counter(), require_card=False,
                      device="cpu", root=tiny_root)
    m = out["metrics"]
    assert m["batch_ms.train"]["value"] > 0
    assert m["step_host_ms.train"]["value"] > m["batch_ms.train"]["value"]
    assert "idle_step_share.train" not in m
