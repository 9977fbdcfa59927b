#!/usr/bin/env python3
"""Sweep the port's scatter kernel (B1) over its slab size and piece size.

    python3 scripts/torch_scatter_sweep.py [--slab-floats 512 1024 2048]
                                           [--piece 64 128 256 512 1024]
                                           [--bucket-piece 2048 ... 32768]
                                           [--shapes NAME ...]

On one NVIDIA GPU: takes the ids of one real training step at every shape
the main path gives the kernel -- the two training shapes (the default
G=512 D=4 f32 path and the G=256 bf16 octa path, as ``chip_smoke.py``
draws them) and every distinct scatter of one step of the ``custom``,
``triplaneline`` and ``voxel_hash`` presets (``chip_smoke.py`` phase 10),
with N(0, 1) values.  Per shape it times the sort once, then, for every
slab size (output floats per slab) and piece size (sorted updates per piece
of a cut slab) of the shape's width class -- or, where the bucket path
takes the shape, for every piece size of a bucket -- the kernel alone
(pre-passes, scatter and fix-up or combine, sort excluded) with CUDA
events, after holding its output against the float64 plain version (1e-5
of the largest row sum).
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


def step_shapes(torch, chip_smoke, scatter):
    """name -> (ids, values, rows, transposed) at every shape of the main
    path, the first of each distinct (N, D, rows) of a preset's step."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(n, d, dtype=torch.float32):
        return torch.randn(n, d, generator=gen, device="cuda").to(dtype)
    shapes = {}
    trainer = chip_smoke.make_trainer(torch, tag="sweep_default")
    ids = chip_smoke.step_ids(torch, trainer)
    shapes["default"] = (ids, randn(ids.numel(), chip_smoke.MAIN_D),
                         chip_smoke.MAIN_ROWS, False)
    del trainer
    trainer = chip_smoke.make_trainer(torch, chip_smoke.OCTA,
                                      tag="sweep_g256_bf16")
    ids = chip_smoke.octa_step_ids(torch, trainer)
    shapes["octa"] = (ids, randn(ids.numel(), 8 * chip_smoke.OCTA_D,
                                 torch.bfloat16), chip_smoke.OCTA_ROWS, True)
    del trainer
    for preset in chip_smoke.ENCODINGS:
        trainer = chip_smoke.make_trainer(torch, tag=f"sweep_{preset}",
                                          config=preset)
        seen = set()
        for i, (ids, shape, dtype, rows) in enumerate(
                chip_smoke.step_scatters(torch, scatter, trainer)):
            if (ids.numel(), shape[1], rows) in seen:
                continue
            seen.add((ids.numel(), shape[1], rows))
            shapes[f"{preset}-{i}"] = (ids, randn(*shape, dtype), rows,
                                       False)
        del trainer
    torch.cuda.empty_cache()
    return shapes


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--slab-floats", type=int, nargs="+",
                        default=[512, 1024, 2048])
    parser.add_argument("--piece", type=int, nargs="+",
                        default=[64, 128, 256, 512, 1024])
    parser.add_argument("--bucket-piece", type=int, nargs="+",
                        default=[2048, 4096, 8192, 16384, 32768])
    parser.add_argument("--shapes", nargs="+", default=None,
                        help="only these shapes (default: all)")
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
    shapes = step_shapes(torch, chip_smoke, scatter)

    results = []
    real = scatter._SLAB_FLOATS, scatter._PIECE, scatter._BUCKET_PIECE
    for name, (ids, vals, num_rows, transposed) in shapes.items():
        if args.shapes and name not in args.shapes:
            continue
        n, d = vals.shape
        cls = scatter._width_class(d)
        bits = 0 if transposed else scatter.bucket_bits(n, vals, num_rows)
        if bits:
            def sort():
                return scatter.sort_by_bucket(ids, vals, num_rows, bits)
            keys, moved = sort()
            settings = [(None, p) for p in args.bucket_piece]
        else:
            def sort():
                return scatter.sort_updates(ids, num_rows)
            keys, perm = sort()
            settings = list(itertools.product(args.slab_floats, args.piece))
        sort_ms = chip_smoke.cuda_ms(torch, sort, reps=20)
        want = scatter._scatter_add_rows_plain(ids, vals, num_rows,
                                               acc_dtype=torch.float64)
        want = want.t() if transposed else want
        tol = 1e-5 * want.abs().max().item()
        print(f"{name}: N={n} D={d} {vals.dtype} rows={num_rows} "
              f"transposed={transposed}, "
              f"{'bucket' if bits else 'sorted'} path: sort {sort_ms:.4f} "
              "ms", flush=True)
        for slab_floats, piece in settings:
            if bits:
                scatter._BUCKET_PIECE = piece

                def run():
                    return scatter._launch_buckets(keys, moved, num_rows,
                                                   bits)
            else:
                # only this shape's width class takes the setting
                scatter._SLAB_FLOATS = tuple(
                    slab_floats if k == cls else v
                    for k, v in enumerate(real[0]))
                scatter._PIECE = tuple(piece if k == cls else v
                                       for k, v in enumerate(real[1]))

                def run():
                    return scatter._launch(keys, perm, vals, num_rows,
                                           transposed)
            label = (f"{name} bucket_piece={piece}" if bits else
                     f"{name} slab_floats={slab_floats} piece={piece}")
            try:
                err = (run().double() - want).abs().max().item()
                ms = chip_smoke.cuda_ms(torch, run, reps=20)
            except RuntimeError as e:   # a slab too big to launch
                print(f"{label}: {e}", flush=True)
                continue
            finally:
                (scatter._SLAB_FLOATS, scatter._PIECE,
                 scatter._BUCKET_PIECE) = real
            if not err <= tol:
                raise AssertionError(f"{label}: error {err} over {tol}")
            results.append(dict(shape=name, n=n, d=d, rows=num_rows,
                                path="bucket" if bits else "sorted",
                                slab_floats=slab_floats, piece=piece,
                                sort_ms=sort_ms, ms=ms, err=err))
            print(f"{label}: kernel {ms:.4f} ms, max_abs_err {err:.3g} "
                  f"(tol {tol:.3g})", flush=True)
        del want, keys
        torch.cuda.empty_cache()
    best = {}
    for r in results:
        if r["shape"] not in best or r["ms"] < best[r["shape"]]["ms"]:
            best[r["shape"]] = r
    for name, r in best.items():
        print(f"best {name} ({r['path']} path): slab_floats="
              f"{r['slab_floats']} piece={r['piece']} kernel {r['ms']:.4f} "
              "ms", flush=True)
    print(json.dumps({"card": smi, "sweep": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
