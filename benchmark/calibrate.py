"""The readings a cell's limits are set from (``benchmark/checks/<cell>.json``),
on the card, at the cell's own size, several seeds in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 3] [--out FILE]

For every seed: the program's numbers (set-up's checked epoch, or one view
rendered by the timed entry, against the plain reference), and for the
first ``--control`` seeds the control's (the reference in the precision
below the configuration's, TF32 matrix products, in the program's place)
and the faults' (training: half of every batch left out, the mean over
the rest; a state left unchanged reads 1 and needs no run; rendering: one
pixel of the view's colour map moved by 0.25); for training also a second
run of the reference against the first (``reference_again``: how far the
reference's own summation order moves the numbers).  One JSON line a
seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(HERE, "cache",
                                                       "kernels")
sys.path.insert(0, os.path.dirname(HERE))


def readings(cell_name: str, seed: int, control: bool, device="cuda",
             root=None) -> dict:
    import numpy as np
    import torch

    from benchmark import compare, harness
    from benchmark.reference import follow

    bench = harness.load_json(os.path.join(root or harness.ROOT,
                                           "BENCHMARK.json"))
    cell = harness.Cell(bench, cell_name, root or harness.ROOT)
    ctx = harness.Context(cell, seed, torch.device(device), False)
    os.makedirs(ctx.scratch, exist_ok=True)
    driver = harness.load_module(cell.driver_path, f"cal_{cell.name}")
    runner = driver.Run(ctx)
    out = {"seed": seed}
    if cell.traffic["driver"] == "train":
        runner.setup()
        runner.release()
        gc.collect()
        torch.cuda.empty_cache() if ctx.device.type == "cuda" else None
        args = (cell.config["config"], runner.scene, ctx.seeds,
                cell.traffic, runner.iters, ctx.device)
        ref = follow.train_epoch(*args)
        prog = dict(runner.checked, changes=compare.change_norms(
            runner.checked["params"], ref["p0"], ctx.device))
        out["program"] = compare.train_numbers(prog, ref)
        if control:
            for name, kw in (("reference_again", {}),
                             ("control", {"tf32": True}),
                             ("half_batch", {"half_batch": True})):
                other = follow.train_epoch(*args, **kw)
                out[name] = compare.train_numbers(other, ref)
    else:
        runner.setup()
        i = ctx.seeds["sample"] % len(runner.poses)
        prog = runner._render(i, runner.resolution)
        runner.release()
        view = (runner.poses[i][None], runner.intrinsics[i][None],
                runner.resolution, ctx.device)
        chunk = int(cell.traffic["check_chunk"])
        ref = follow.render_view(runner.data, ctx.seeds["weights"], *view,
                                 chunk=chunk)
        out["program"] = compare.render_numbers(prog, ref)
        if control:
            out["control"] = compare.render_numbers(follow.render_view(
                runner.data, ctx.seeds["weights"], *view, chunk=chunk,
                tf32=True), ref)
            bad = [a.copy() for a in prog]
            v = bad[0][0, :, 0, 0]
            bad[0][0, :, 0, 0] = np.where(v > 0.5, v - 0.25, v + 0.25)
            out["altered_pixel"] = compare.render_numbers(bad, ref)
    shutil.rmtree(ctx.scratch, ignore_errors=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--control", type=int, default=3,
                   help="run the control and the faults on this many of "
                   "the first seeds")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    f = open(args.out, "a") if args.out else None
    try:
        for k, seed in enumerate(seeds):
            t0 = time.perf_counter()
            r = readings(args.workload, seed, k < args.control)
            r["seconds"] = time.perf_counter() - t0
            line = json.dumps(r)
            print(line, flush=True)
            if f:
                f.write(line + "\n")
                f.flush()
    finally:
        if f:
            f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
