"""The benchmark's driver: finds a cell's pieces by name, checks the card,
runs set-up, the measured window and the comparison, and prints the
result.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix.  The harness reads:

- ``BENCHMARK.json``'s configuration entry, whose ``file`` holds the
  configuration as it is run (``benchmark/configs/<config>.json``);
- ``benchmark/traffic/<traffic>.json``: the traffic's parameters and the
  driver that runs it;
- ``benchmark/drivers/<driver>.py``: the entry the window drives;
- ``benchmark/checks/<cell>.json``: the limit of each number the
  comparison with the plain reference gives;
- ``benchmark/metrics/<quantity>.py``: one reader per per-layer quantity.

A metric's name is its quantity, or ``<quantity>.<variant>`` where cells
that report the same quantity need metrics of their own (a bound of its
own for an end-to-end metric; a per-layer metric names the end-to-end
metric it moves): ``train_rays_per_s.custom`` reports the window's
``train_rays_per_s``, and ``gemm_ms.custom`` is read by
``metrics/gemm_ms.py`` (:func:`quantity`).

Adding a configuration, a traffic mix, a cell or a metric is adding files
and entries; no file here changes.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "ndjir_tpu")


class Refused(Exception):
    """The run cannot measure: no result is printed."""


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise Refused(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell of ``BENCHMARK.json`` with every file it names loaded."""

    def __init__(self, bench: Dict, name: str, root: str = ROOT):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise Refused(f"no workload {name!r} in BENCHMARK.json")
        self.entry = by_name[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(os.path.join(
            root, configs[self.entry["config"]]["file"]))
        self.traffic_name = self.entry["traffic"]
        self.traffic = load_json(os.path.join(
            root, "benchmark", "traffic", f"{self.traffic_name}.json"))
        self.limits = load_json(os.path.join(
            root, "benchmark", "checks", f"{name}.json"))["limits"]
        self.driver_path = os.path.join(root, "benchmark", "drivers",
                                        f"{self.traffic['driver']}.py")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]
        self.metric_dir = os.path.join(root, "benchmark", "metrics")


def seeds(seed: int) -> Dict[str, int]:
    """Independent 32-bit seeds for the scene, the weights, the data
    layer's draws and the check's sample, from ``--seed`` (any size)."""
    import numpy as np
    s = np.random.SeedSequence(seed).generate_state(4, dtype=np.uint32)
    return {"scene": int(s[0]), "weights": int(s[1]), "data": int(s[2]),
            "sample": int(s[3])}


def card_state() -> Dict[str, str]:
    """The card's name, power limit, clocks and temperature as nvidia-smi
    reads them (empty if it cannot)."""
    q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return {}
    first = out.splitlines()[0].split(", ") if out else []
    return dict(zip(q.split(","), first))


def clear_stale_locks(dirs: List[str]) -> None:
    """Remove ``lock`` files a build cut off mid-way may have left."""
    for d in dirs:
        for base, _, files in os.walk(d):
            for f in files:
                if f == "lock":
                    os.remove(os.path.join(base, f))


def quantity(metric: str) -> str:
    """What a metric reports: the window's quantity of that name for an
    end-to-end metric, the reader ``metrics/<quantity>.py`` for a
    per-layer one; the name up to its first dot."""
    return metric.split(".")[0]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a driver gets: the cell, its seeds, its device and scratch
    directory, whether the window is traced, and the host spans the
    driver records (``span``): their total ms by name (``host_ms``) and
    each interval on the profiler's clock (``spans``)."""

    def __init__(self, cell: Cell, seed: int, device, trace: bool):
        self.cell, self.device = cell, device
        self.seeds = seeds(seed)
        self.trace = trace
        self.host_ms: Dict[str, float] = {}
        self.spans: List = []
        self.scratch = os.path.join(tempfile.gettempdir(), "ndjir-bench",
                                    cell.name)

    def span(self, name: str, fn):
        """``fn`` wrapped so that its host time adds to ``host_ms[name]``
        and its interval, on the wall clock in ns as the profiler's
        events are, to ``spans``."""
        def timed(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.time_ns()
                self.spans.append((f"bench.{name}", t0 * 1e-9, t1 * 1e-9))
                self.host_ms[name] = self.host_ms.get(name, 0.0) \
                    + 1e-6 * (t1 - t0)
        return timed


def run(args, t_start: float, require_card: bool = True,
        device: Optional[str] = None, root: str = ROOT) -> Dict:
    """One run of a cell, its files found under ``root``; returns the
    result object.  ``require_card=False`` and a ``device`` let the tests
    drive a run on the CPU."""
    import torch

    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = Cell(bench, args.workload, root)
    if require_card:
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false: no card")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{torch.cuda.device_count()} cards, the cell "
                          f"asks for {cell.chips}")
    device = torch.device(device or "cuda")
    kind = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    ctx = Context(cell, args.seed, device, bool(args.trace))
    shutil.rmtree(ctx.scratch, ignore_errors=True)
    os.makedirs(ctx.scratch)
    driver = load_module(cell.driver_path, f"bench_driver_{cell.name}")
    runner = driver.Run(ctx)
    compile_s = [0.0]
    if device.type == "cuda":
        _time_kernel_builds(compile_s)
    try:
        runner.setup()
        if device.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        trace = None
        if ctx.trace:
            from benchmark.trace import traced
            window, trace = traced(lambda: runner.window(args.seconds),
                                   device.type == "cuda", ctx.spans)
            # the traced window's own end-to-end rates, to hold against an
            # untraced run's: what the profiler costs
            print("traced window: " + ", ".join(
                f"{k} {v!r}" for k, v in window["metrics"].items()))
        else:
            window = runner.window(args.seconds)
        peak = (torch.cuda.max_memory_reserved(device)
                if device.type == "cuda" else 0)
        runner.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = runner.check(cell.limits)
    finally:
        shutil.rmtree(ctx.scratch, ignore_errors=True)

    metrics: Dict[str, Dict] = {}
    if not ctx.trace:
        e2e = dict(window["metrics"], setup_s=setup_s,
                   peak_mem_gib=peak / 2 ** 30)
        for m in cell.end_to_end:
            name = quantity(m["name"])
            if name in e2e:
                metrics[m["name"]] = {"value": e2e[name], "unit": m["unit"]}
    else:
        from benchmark.trace import TraceRun
        tr = TraceRun(trace, window, ctx, kind)
        for m in cell.per_layer:
            q = quantity(m["name"])
            reader = load_module(os.path.join(cell.metric_dir, f"{q}.py"),
                                 f"bench_metric_{q}")
            value = reader.read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(c["value"] is not None and c["limit"] is not None
                  and c["value"] <= c["limit"] for c in checks) \
        and window["failed"] == 0 and bool(checks)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": window["attempted"],
           "failed": window["failed"], "metrics": metrics, "device": dev}
    if ctx.trace:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        out["breakdown"] = trace.breakdown()
    # nvcc's share of set-up: above 0 only in a checkout's first run
    out["setup_compile_s"] = compile_s[0]
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out


def _time_kernel_builds(total: List[float]) -> None:
    """Add the host time of the port's nvcc builds to ``total[0]``."""
    from ndjir_torch import kernels

    real = kernels.build

    def build(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            total[0] += time.perf_counter() - t0
    kernels.build = build


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache = os.path.join(HERE, "cache", "kernels")
    os.makedirs(cache, exist_ok=True)
    clear_stale_locks([cache, os.path.join(ROOT, "ndjir_torch", "csrc",
                                           "build")])
    try:
        out = run(args, t_start)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"refused: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    card = card_state()
    import torch
    print(f"card: {out['device']['kind']}, {out['device']['count']} in use "
          f"of {torch.cuda.device_count()}; nvidia-smi: "
          + ", ".join(f"{k} {v}" for k, v in card.items()))
    print("shares are of the published peaks (counts.card_peaks) at the "
          f"power limit {card.get('power.limit', 'not read')}")
    print(f"setup_s includes {out['setup_compile_s']:.3f} s of nvcc builds")
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0
