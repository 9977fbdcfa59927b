#!/usr/bin/env python3
"""Sweep the port's scatter kernel (B1) over its slab size and heavy limit.

    python3 scripts/torch_scatter_sweep.py [--slab-floats 1024 2048]
                                           [--heavy 16 64]

On one NVIDIA GPU: takes the step's own ids at both training shapes (the
default G=512 D=4 f32 path and the G=256 bf16 octa path, as
``chip_smoke.py`` draws them), and for every slab size (output floats per
slab) and heavy-slab limit (updates above which a whole block sums a slab)
times the kernel alone
(pre-pass and scatter, sort excluded) with CUDA events, after holding its
output against the float64 plain version (1e-5 of the largest row sum).
Prints one line per setting and a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--slab-floats", type=int, nargs="+",
                        default=[1024, 2048])
    parser.add_argument("--heavy", type=int, nargs="+", default=[16, 64])
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_scatter_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from ndjir_torch.ops import scatter

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    chip_smoke.OUT_DIR = os.path.join(HERE, "chip_smoke_out", "sweep")
    shapes = {}
    trainer = chip_smoke.make_trainer(torch, tag="sweep_default")
    ids = chip_smoke.step_ids(torch, trainer)
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes["default"] = (ids, torch.randn(ids.numel(), chip_smoke.MAIN_D,
                                          generator=gen, device="cuda"),
                         chip_smoke.MAIN_ROWS, False)
    del trainer
    trainer = chip_smoke.make_trainer(torch, chip_smoke.OCTA,
                                      tag="sweep_g256_bf16")
    ids = chip_smoke.octa_step_ids(torch, trainer)
    shapes["octa"] = (ids, torch.randn(ids.numel(), 8 * chip_smoke.OCTA_D,
                                       generator=gen, device="cuda")
                      .to(torch.bfloat16), chip_smoke.OCTA_ROWS, True)
    del trainer
    torch.cuda.empty_cache()
    # the same outputs with no update at all: only the dense zero write
    for name in list(shapes):
        ids, vals, num_rows, transposed = shapes[name]
        shapes[f"{name}-no-updates"] = (ids[:0], vals[:0], num_rows,
                                        transposed)

    results = []
    real = scatter._SLAB_FLOATS, scatter._HEAVY
    for name, (ids, vals, num_rows, transposed) in shapes.items():
        ids32, perm = scatter.sort_updates(ids)
        want = scatter._scatter_add_rows_plain(ids, vals, num_rows,
                                               acc_dtype=torch.float64)
        want = want.t() if transposed else want
        tol = 1e-5 * max(1.0, want.abs().max().item())
        for slab_floats, heavy in itertools.product(args.slab_floats,
                                                    args.heavy):
            # both paths (D <= 4 and D > 4) take the setting
            scatter._SLAB_FLOATS = (slab_floats, slab_floats)
            scatter._HEAVY = (heavy, heavy)

            def run():
                return scatter._launch(ids32, perm, vals, num_rows,
                                       transposed)
            label = f"{name} slab_floats={slab_floats} heavy={heavy}"
            try:
                err = (run().double() - want).abs().max().item()
                ms = chip_smoke.cuda_ms(torch, run, reps=20)
            except RuntimeError as e:   # a slab too big to launch
                print(f"{label}: {e}", flush=True)
                continue
            if not err <= tol:
                raise AssertionError(f"{label}: error {err} over {tol}")
            results.append(dict(shape=name, slab_floats=slab_floats,
                                heavy=heavy, ms=ms, err=err))
            print(f"{label}: kernel {ms:.4f} ms, max_abs_err {err:.3g} "
                  f"(tol {tol:.3g})", flush=True)
        scatter._SLAB_FLOATS, scatter._HEAVY = real
        del want
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "sweep": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
