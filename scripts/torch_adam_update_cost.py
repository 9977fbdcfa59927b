#!/usr/bin/env python3
"""What the dual-Adam update costs on the card, and how PyTorch rounds it.

    python3 scripts/torch_adam_update_cost.py [--grid 512] [--reps 20]
                                              [--probe]

On one NVIDIA GPU: the default preset's parameter tree at ``--grid`` (86
leaves; at G=512 the grid table is 512^3 x 4 f32, 2.1 GB) with random
gradients, and the optimizer's two paths, ``apply_updates_plain``
(PyTorch's passes, ``plain``) and ``apply_updates`` (the two CUDA kernels
for the f32 leaves, ``fused``), timed by CUDA events over ``--reps``
calls, in turn: issued eagerly (the host's launches included) and
captured once in a CUDA graph and replayed (device time only), for the
whole tree, the table leaf alone and the other 85 leaves.  Beside each,
the bytes bound of the kernel pair (read g, p; read g, p, m, v and write
p, m, v: 9 floats an element) at the card's published bandwidth.

``--probe`` also tells how PyTorch's CUDA kernels round the optimizer's
ops on inputs that cancel: ``add_(b, alpha=s)`` and
``addcmul_(b, b, value=s)`` against one rounding of the exact result
(a fused multiply-add) and against rounding each product first, and
``sqrt`` and ``div`` against numpy's correctly rounded ones.

Prints the card's name and power limit, one line per measurement and a
JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANDWIDTH = 3.35e12  # H100 SXM, bytes/s (NVIDIA's data sheet)


def subtree(tree, paths):
    """The leaves of ``tree`` at ``paths``, as a nested dict."""
    out = {}
    for path in paths:
        src, dst = tree, out
        for k in path[:-1]:
            src, dst = src[k], dst.setdefault(k, {})
        dst[path[-1]] = src[path[-1]]
    return out


def event_ms(torch, fn, reps):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(torch, fn, reps):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = event_ms(torch, graph.replay, reps)
    del graph
    return ms


def round_f32(x64):
    """float64 values that are exact sums -> f32, rounded once."""
    return x64.astype(np.float32)


def probe(torch, log):
    """Which rounding PyTorch's CUDA kernels take for the optimizer's ops."""
    rng = np.random.RandomState(0)
    n = 1 << 20
    out = {}
    for name, alpha in (("add_alpha_1-b1", 1 - 0.9), ("add_alpha_wd", 1e-3)):
        b = rng.randn(n).astype(np.float32)
        s = np.float32(alpha)
        prod64 = np.float64(s) * b.astype(np.float64)          # exact
        # a cancels the product to a few bits: the two roundings differ
        a = (-prod64.astype(np.float32)
             * (1 + rng.uniform(-1e-3, 1e-3, n)).astype(np.float32)
             ).astype(np.float32)
        got = torch.from_numpy(a.copy()).cuda().add_(
            torch.from_numpy(b).cuda(), alpha=alpha).cpu().numpy()
        fma = round_f32(a.astype(np.float64) + prod64)
        sep = round_f32(a.astype(np.float64)
                        + prod64.astype(np.float32).astype(np.float64))
        out[name] = {"fma": float(np.mean(got.view(np.int32)
                                          == fma.view(np.int32))),
                     "mul_then_add": float(np.mean(got.view(np.int32)
                                                   == sep.view(np.int32))),
                     "alpha_f32": float(s)}
        log(f"{name}: {out[name]}")
    value = 1 - 0.999
    s = np.float32(value)
    g = rng.randn(n).astype(np.float32)
    g64 = g.astype(np.float64)
    sg = (np.float64(s) * g64).astype(np.float32).astype(np.float64)
    gg = (g64 * g64).astype(np.float32).astype(np.float64)
    hyps = {"fma(s*g, g, v)": sg * g64,
            "fma(s, g*g, v)": np.float64(s) * gg,
            "v + (s*g)*g": (sg * g64).astype(np.float32).astype(np.float64),
            "v + s*(g*g)": (np.float64(s) * gg).astype(np.float32)
            .astype(np.float64)}
    v = (-(sg * g64).astype(np.float32)
         * (1 + rng.uniform(-1e-3, 1e-3, n)).astype(np.float32)
         ).astype(np.float32)
    gc = torch.from_numpy(g).cuda()
    got = torch.from_numpy(v.copy()).cuda().addcmul_(gc, gc, value=value) \
        .cpu().numpy()
    out["addcmul"] = {k: float(np.mean(
        got.view(np.int32)
        == round_f32(v.astype(np.float64) + h).view(np.int32)))
        for k, h in hyps.items()}
    log(f"addcmul value=1-b2: {out['addcmul']}")
    x = np.abs(rng.randn(n)).astype(np.float32) * 1e-3
    y = rng.randn(n).astype(np.float32)
    xt, yt = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    out["sqrt_rn"] = float(np.mean(torch.sqrt(xt).cpu().numpy().view(
        np.int32) == np.sqrt(x).view(np.int32)))
    out["div_rn"] = float(np.mean((yt / xt).cpu().numpy().view(np.int32)
                                  == (y / x).view(np.int32)))
    log(f"sqrt rounded once: {out['sqrt_rn']}, div: {out['div_rn']}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--grid", type=int, default=512)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--probe", action="store_true")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_adam_update_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from ndjir_torch.config import load_config
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.train import optim

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    def log(msg):
        print(f"[adam] {msg}", flush=True)

    summary = {"card": smi, "torch": torch.__version__,
               "cuda": torch.version.cuda, "grid": args.grid}
    if args.probe:
        summary["probe"] = probe(torch, log)

    conf = load_config("default", [
        f"geometric_network.voxel.grid_size={args.grid}"])
    params = init_model(conf, seed=0, device="cuda")
    state = optim.init_optimizer(params)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    grads = optim.tree_map(
        lambda p: 1e-3 * torch.randn(p.shape, generator=gen, device="cuda"),
        params)
    leaves = [path for path, _ in optim.tree_leaves_with_path(params)]
    table = [p for p in leaves if optim.is_grid_feature_path(p)]
    small = [p for p in leaves if p not in table]
    lr_w = torch.tensor(1e-3, device="cuda")
    lr_f = torch.tensor(1e-2, device="cuda")
    paths = {"plain": optim.apply_updates_plain,
             "fused": optim.apply_updates}
    times = {}
    for part, keys in (("tree", leaves), ("table", table),
                       ("small", small)):
        sub = (subtree(params, keys), subtree(grads, keys),
               {"count": state["count"], "mu": subtree(state["mu"], keys),
                "nu": subtree(state["nu"], keys)})
        elems = sum(t.numel() for _, t
                    in optim.tree_leaves_with_path(sub[0]))
        bound = 9 * 4 * elems / BANDWIDTH * 1e3
        times[part] = {"leaves": len(keys), "elems": elems,
                       "bound_ms": bound}
        for name in ("plain", "fused", "fused", "plain"):
            def step(fn=paths[name]):
                fn(*sub, lr_w, lr_f, conf)
            eager = event_ms(torch, step, args.reps)
            replay = graph_ms(torch, step, args.reps)
            times[part].setdefault(name, []).append(
                {"eager_ms": eager, "replay_ms": replay})
            log(f"{part} {name}: {len(keys)} leaves, {elems} elements: "
                f"eager {eager:.4f} ms, replayed {replay:.4f} ms, bound "
                f"{bound:.4f} ms")
    summary["times"] = times
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
