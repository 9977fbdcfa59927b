"""The traced window's arithmetic: busy time as the union of the device's
intervals, device time by kernel kind, idle gaps named by the innermost
host range open when the device went idle, and the shares the readers
take."""

import types

import pytest

from benchmark import trace


def a_trace():
    kernels = [("ampere_sgemm_128x64_nn", 1.0, 2.0),
               # overlaps the GEMM on a second stream: counted once
               ("vectorized_elementwise_kernel", 1.5, 2.5),
               ("index_select_kernel", 3.0, 3.5),
               ("scatter_add_rows_kernel", 6.0, 7.0)]
    host = [("bench.host_batch", 2.4, 5.9),
            ("cudaStreamSynchronize", 2.6, 2.9),
            ("cudaLaunchKernel", 5.5, 5.6)]
    return trace.Trace(kernels, host, window_s=8.0)


def test_busy_is_the_union_of_device_intervals():
    t = a_trace()
    assert t.busy_intervals == [(1.0, 2.5), (3.0, 3.5), (6.0, 7.0)]
    assert t.busy_s == pytest.approx(3.0)


def test_kinds_sum_each_kernels_own_time():
    k = a_trace().kind_seconds()
    assert k == pytest.approx({"gemm": 1.0, "elementwise": 1.0,
                               "gather": 0.5, "b1": 1.0})


def test_idle_gaps_are_named_by_the_innermost_open_range():
    gaps = a_trace().idle_by_host()
    # 2.5 -> 3.0 inside the batch span (the sync has not begun at 2.5),
    # 3.5 -> 6.0 inside it too; 1 s before the first kernel and 1 s after
    # the last
    assert gaps == pytest.approx({
        "bench.host_batch": 0.5 + 2.5,
        "(before the first and after the last kernel)": 2.0})


def test_a_gap_inside_a_runtime_call_is_named_by_it():
    t = trace.Trace([("k", 0.0, 1.0), ("k", 2.0, 3.0)],
                    [("bench.host_batch", 0.5, 2.5),
                     ("cudaStreamSynchronize", 0.9, 1.8)], window_s=3.0)
    assert t.idle_by_host() == pytest.approx({
        "cudaStreamSynchronize": 1.0,
        "(before the first and after the last kernel)": 0.0})


def test_shares_and_rates_of_a_run():
    t = a_trace()
    window = {"kind": "train", "attempted": 4, "rays": 4 * 2048,
              "conf": {"precision": {"mlp_dtype": "float32"}}}
    ctx = types.SimpleNamespace(host_ms={"host_batch": 8.0})
    run = trace.TraceRun(t, window, ctx, "NVIDIA H100 80GB HBM3")
    assert run.idle_share() == pytest.approx(100.0 * (1 - 3.0 / 8.0))
    assert run.kind_ms_per_unit("gemm") == pytest.approx(250.0)
    assert run.host_ms_per_unit("host_batch") == pytest.approx(2.0)
    assert run.kind_ms_per_unit("sort") is None
