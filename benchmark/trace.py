"""The traced window: ``torch.profiler`` over the window, reduced to the
device's kernel intervals, the host's ranges, and what the per-layer
metric readers (``benchmark/metrics/<quantity>.py``) take from them.

On the card the profiler records the device's activity alone (CUPTI: the
kernels, copies and sets, and the host's CUDA runtime calls), not the
host's operators: recording every operator costs the host-bound cells
more time than their own dispatch, and would read as idle device time.
The host ranges are those runtime calls and the driver's own spans
(``harness.Context.span``), on the profiler's clock (the wall clock).

Busy time is the union of the device's kernel, copy and set intervals on
the trace's timeline, so that kernels overlapping on two streams count
once; idle share is 1 - busy / window.  Device time by kind sums each
kernel's own duration, by its name (``KINDS``, first match wins).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from benchmark import counts

# kernel kinds by substrings of the kernel's name, first match wins: the
# scatter kernel B1 (its own kernels and its CUB radix sort; PyTorch's
# sorts are segmented or its own), the fold kernel B2, GEMMs, sorts,
# gathers and index kernels, reductions, elementwise work (jiterator
# kernels, copies, casts, cat, memcpy and memset included)
KINDS = (("b1", ("scatter_keys_kernel", "scatter_slab_starts_kernel",
                 "scatter_slab_search_kernel", "scatter_plan_kernel",
                 "scatter_add_rows_kernel", "scatter_fixup_kernel",
                 "scatter_bucket_kernel", "scatter_bucket_combine_kernel",
                 "DeviceRadixSortOnesweepKernel",
                 "DeviceRadixSortHistogramKernel",
                 "DeviceRadixSortExclusiveSumKernel",
                 "DeviceRadixSortSingleTileKernel",
                 "DeviceRadixSortUpsweepKernel",
                 "DeviceRadixSortDownsweepKernel",
                 "RadixSortScanBinsKernel")),
         ("b2", ("fold_octa_cotangent_kernel",)),
         ("gemm", ("gemm", "Gemm", "GEMM", "splitKreduce")),
         ("sort", ("Sort", "sort")),
         ("gather", ("index", "Index", "gather", "Gather")),
         ("reduction", ("reduce", "Reduce")),
         ("elementwise", ("elementwise", "Elementwise", "jitted",
                          "softplus_grad", "Copy", "copy", "Memcpy",
                          "Memset", "CatArray", "fill")))


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


class Trace:
    """Kernel intervals (seconds on the trace's clock) and host ranges of
    one traced window."""

    def __init__(self, kernels: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]], window_s: float):
        self.window_s = window_s
        kernels.sort(key=lambda k: k[1])
        self.names = [k[0] for k in kernels]
        self.start = np.array([k[1] for k in kernels], dtype=np.float64)
        self.end = np.array([k[2] for k in kernels], dtype=np.float64)
        host.sort(key=lambda h: (h[1], -h[2]))
        self.host = host
        self.busy_intervals = self._union()
        self.busy_s = float(sum(e - s for s, e in self.busy_intervals))
        self._kinds: Optional[Dict[str, float]] = None

    def _union(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for s, e in zip(self.start, self.end):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def seconds_by(self, key: Callable[[str], Optional[str]]
                   ) -> Dict[str, float]:
        """Device seconds of the kernels summed by ``key(name)`` (None
        drops a kernel)."""
        out: Dict[str, float] = {}
        for n, s, e in zip(self.names, self.start, self.end):
            k = key(n)
            if k is not None:
                out[k] = out.get(k, 0.0) + float(e - s)
        return out

    def kind_seconds(self) -> Dict[str, float]:
        if self._kinds is None:
            kinds: Dict[str, str] = {}

            def key(name):
                k = kinds.get(name)
                if k is None:
                    k = kinds[name] = kind_of(name)
                return k
            self._kinds = self.seconds_by(key)
        return self._kinds

    def idle_by_host(self) -> Dict[str, float]:
        """The idle time between device intervals, summed by the innermost
        host range open when the device went idle (of the ranges that
        started before the gap and end after its start, the one that
        started last), in one sweep over gaps and ranges in time order."""
        b = self.busy_intervals
        gaps = [(b[i][1], b[i + 1][0] - b[i][1]) for i in range(len(b) - 1)]
        out: Dict[str, float] = {}
        stack: List[Tuple[str, float, float]] = []
        j = 0
        for t, dur in gaps:
            while j < len(self.host) and self.host[j][1] <= t:
                stack.append(self.host[j])
                j += 1
            # the ranges still open at t, the innermost last
            open_ = [h for h in stack if h[2] >= t]
            stack = open_
            name = open_[-1][0][:120] if open_ \
                else "(host, outside any span or CUDA call)"
            out[name] = out.get(name, 0.0) + dur
        if b:
            out["(before the first and after the last kernel)"] = \
                self.window_s - (b[-1][1] - b[0][0])
        return out

    def breakdown(self, top: int = 10) -> Dict:
        """The device operations that took most time, and the idle time
        between kernels by what the host was doing (:meth:`idle_by_host`),
        the ten largest of each."""
        ops = sorted(self.seconds_by(lambda n: n[:120]).items(),
                     key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:top] if s > 0]}


def traced(window: Callable[[], Dict], cuda: bool,
           spans: List[Tuple[str, float, float]]):
    """(the window's result, its :class:`Trace`): ``window()`` run under
    ``torch.profiler`` (on the card its CUDA activity alone; without a
    card, as in the tests, the host's operators), the window's wall time
    on the host clock; ``spans`` (name, start s, end s on the wall clock)
    the driver's own host spans, which the window appends to.  The
    profiler's raw events are read directly: building its per-event
    Python objects takes minutes for the many kernels of a window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    n0 = len(spans)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = window()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    kernels, host = [], list(spans[n0:])
    cuda_type = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        span = (e.name(), s, s + e.duration_ns() * 1e-9)
        (kernels if e.device_type() == cuda_type else host).append(span)
    return result, Trace(kernels, host, window_s)


class TraceRun:
    """What a per-layer metric reader gets: the trace, the window's
    counts (``units``: steps or views; ``rays``), the host spans the
    driver recorded (``host_ms``), the configuration as run, and the
    card's published peaks; and the readings the metric files share.
    Each returns None where it finds nothing to read."""

    def __init__(self, trace: Trace, window: Dict, ctx, kind: str):
        self.trace = trace
        self.kind = window["kind"]          # "train" or "render"
        self.units = window["attempted"]
        self.rays = window["rays"]
        self.window_s = trace.window_s
        self.host_ms = dict(ctx.host_ms)
        self.conf = window["conf"]
        self.scatter_shapes = window.get("scatter_shapes", [])
        self.scatter_launches = window.get("scatter_launches", 0)
        self.peaks = counts.card_peaks(kind) if "H100" in kind \
            or "H200" in kind else None

    def kind_ms_per_unit(self, kind: str) -> Optional[float]:
        """Device ms of the kernels of ``kind`` (:data:`KINDS`) a step or
        a view."""
        s = self.trace.kind_seconds().get(kind)
        if s is None or self.units == 0:
            return None
        return 1e3 * s / self.units

    def host_ms_per_unit(self, span: str) -> Optional[float]:
        """Host ms of the driver's span ``span`` a step or a view."""
        ms = self.host_ms.get(span)
        if ms is None or self.units == 0:
            return None
        return ms / self.units

    def idle_share(self) -> Optional[float]:
        """% of the window in which no kernel, copy or set ran."""
        if self.trace.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.window_s)

    def b1_roofline(self) -> Optional[float]:
        """B1's share of its roofline, %: each launch's least time
        (:func:`counts.scatter_bytes` over the published HBM rate; one add
        per value keeps it far from the FLOP bound) summed over a step,
        over B1's device time a step.  The launches a step come from
        ``kernels.LAUNCHES`` and must match the shapes set-up recorded."""
        b1_s = self.trace.kind_seconds().get("b1")
        if not (b1_s and self.scatter_shapes and self.peaks and self.units):
            return None
        if self.scatter_launches != len(self.scatter_shapes) * self.units:
            return None
        least = sum(counts.scatter_bytes(*s) for s in self.scatter_shapes) \
            / self.peaks["bytes_per_s"]
        return 100.0 * least * self.units / b1_s

    def step_mfu(self) -> Optional[float]:
        """The window's matrix FLOPs (:mod:`benchmark.counts`) over its
        time and the card's published peak for the MLP's precision, %."""
        if self.peaks is None or self.units == 0:
            return None
        peak = self.peaks[self.conf["precision"]["mlp_dtype"]]
        if self.kind == "train":
            flops = counts.train_step_flops(self.conf) * self.units
        else:
            flops = counts.render_ray_flops(self.conf) * self.rays
        return 100.0 * flops / self.window_s / peak
