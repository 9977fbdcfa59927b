"""The program's own spans in a traced window: what the readers of
``batch_ms``, ``step_host_ms`` and ``idle_step_share`` take from them.

``ndjir_torch.utils.profiling`` records a span for each phase of the
trainer's loop and step while a profiler runs (``spans()``: name, start
and end in ns on the wall clock, the profiler's clock, its id and its
parent's, the global step, and counts such as ``steps=k`` on a batch or a
call).  A program without them (``spans()`` missing or empty) gives every
reading None.  Each reading divides by the steps that the program's own
``steps`` counts add up to, and is None where that sum is not the
window's step count (``TraceRun.units``).

    python3 benchmark/program_spans.py --workload <cell> --seed <n> \\
        --seconds <s>

runs the cell's traced run and prints, beside its per-layer metrics, the
device's idle seconds by the innermost program span open when the device
went idle (:func:`idle_by_span`), which no metric reads.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

# the spans inside which the host dispatches a step: an eager step, or a call
# of k steps (the captured step's replays)
STEP_SPANS = ("train.step", "train.call")
OUTSIDE = "(outside any program span)"
EDGES = "(before the first and after the last kernel)"


def window_spans(run) -> Optional[List]:
    """The program's spans that overlap the traced window (the window_s
    before its last host event or kernel end), or None without any."""
    from ndjir_torch.utils import profiling

    get = getattr(profiling, "spans", None)
    tr = run.trace
    ends = [h[2] for h in tr.host]
    if len(tr.end):
        ends.append(float(tr.end.max()))
    if get is None or not ends:
        return None
    t1 = max(ends)
    t0 = t1 - run.window_s
    found = [s for s in get()
             if s.start_ns * 1e-9 < t1 and s.end_ns * 1e-9 > t0]
    return found or None


def _steps(spans: Sequence, names: Sequence[str]) -> int:
    return sum(s.counts.get("steps", 0) for s in spans if s.name in names)


def host_ms_per_step(run, names: Sequence[str]) -> Optional[float]:
    """Host ms a step in the program's spans named ``names``, over the
    steps their ``steps`` counts add up to; None where that sum is not the
    window's step count."""
    spans = window_spans(run)
    if not spans or run.units == 0 or _steps(spans, names) != run.units:
        return None
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name in names)
    return 1e-6 * ns / run.units


def _innermost(gap_starts: Sequence[float], spans: Sequence) -> List:
    """For each time (s, ascending), the innermost program span open then
    (of those started at or before it and ending after it, the one that
    started last), or None; one sweep over times and spans in order."""
    spans = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    out, stack, j = [], [], 0
    for t in gap_starts:
        tn = t * 1e9
        while j < len(spans) and spans[j].start_ns <= tn:
            stack.append(spans[j])
            j += 1
        stack = [s for s in stack if s.end_ns > tn]
        out.append(stack[-1] if stack else None)
    return out


def _gaps(run):
    b = run.trace.busy_intervals
    return [(b[i][1], b[i + 1][0] - b[i][1]) for i in range(len(b) - 1)]


def idle_step_share(run) -> Optional[float]:
    """% of the window in idle gaps between device intervals that began
    while the innermost open program span was a step's (``train.step``,
    ``train.call``) or one of its descendants: the device starved by the
    step's dispatch."""
    spans = window_spans(run)
    if not spans or not run.trace.busy_intervals or run.units == 0 \
            or _steps(spans, STEP_SPANS) != run.units:
        return None
    by_id = {s.span_id: s for s in spans}
    in_step: Dict[int, bool] = {}

    def under_step(s) -> bool:
        if s.span_id not in in_step:
            parent = by_id.get(s.parent_id)
            in_step[s.span_id] = s.name in STEP_SPANS or (
                parent is not None and under_step(parent))
        return in_step[s.span_id]
    gaps = _gaps(run)
    inner = _innermost([t for t, _ in gaps], spans)
    idle = sum(d for (_, d), s in zip(gaps, inner)
               if s is not None and under_step(s))
    return 100.0 * idle / run.window_s


def idle_by_span(run) -> Optional[Dict[str, float]]:
    """The device's idle seconds by the innermost program span open when
    it went idle (``OUTSIDE`` where none was), and the window's edges
    (``EDGES``); they add up to the window less the device's busy time."""
    spans = window_spans(run)
    b = run.trace.busy_intervals
    if not spans or not b:
        return None
    gaps = _gaps(run)
    out: Dict[str, float] = {}
    for (_, d), s in zip(gaps, _innermost([t for t, _ in gaps], spans)):
        name = OUTSIDE if s is None else s.name
        out[name] = out.get(name, 0.0) + d
    out[EDGES] = run.window_s - (b[-1][1] - b[0][0])
    return out


def main(argv=None) -> int:
    """A cell's traced run (``harness.main`` with ``--trace 1``: its
    lines and its result), then one JSON line of the device's idle time
    by program span."""
    import argparse
    import json
    import os
    import sys
    import time

    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # run.py's environment (kernel cache, one host thread), before torch
    import benchmark.run  # noqa: F401
    from benchmark import harness, trace

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    runs = []

    class Recorded(trace.TraceRun):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)
    trace.TraceRun = Recorded
    rc = harness.main(["--workload", args.workload, "--seed",
                       str(args.seed), "--seconds", str(args.seconds),
                       "--trace", "1"], t_start=t_start)
    if rc or not runs:
        return rc or 1
    run = runs[-1]
    idle = idle_by_span(run) or {}
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "idle_by_span_share": 100.0 * sum(idle.values()) / run.window_s,
        "device_idle_share": run.idle_share(), "steps": run.units,
        "window_s": run.window_s}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
