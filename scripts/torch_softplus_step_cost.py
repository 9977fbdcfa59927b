#!/usr/bin/env python3
"""What softplus's first derivative costs a captured training step.

    python3 scripts/torch_softplus_step_cost.py [--rounds 3]
                                                [--paths default g256_bf16]

On one NVIDIA GPU: builds ``chip_smoke.py`` phase 13's trainer for each
path (32 views, ``train.steps_per_call=8``, so an epoch is one call of
``train_steps``: 8 replays of one captured step) and times the step with
three versions of ``ndjir_torch.ops.activations.softplus``'s backward, in
turn, ``--rounds`` times in one process:

- ``fused``: ``F.softplus`` under autograd, the fused op's own backward
  (1/2 at x = 0: the derivative before the tie was repaired);
- ``two_pass``: the port's ``softplus`` with its first derivative as the
  plain version, ``softplus_backward`` and then a masked fill of the zeros;
- ``kernel``: the port's ``softplus`` as it ships, the first derivative one
  jiterator kernel.

Each version releases the graph, so the next epoch warms up and captures
anew; that epoch is not timed, the next ``--epochs`` are, by the host clock
around synchronized epochs.  Prints the card's name and power limit, one
line per (path, round, version) and a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERSIONS = ("fused", "two_pass", "kernel")


def use_version(version, activations, F):
    """Point ``activations`` at ``version``'s backward; returns the undo."""
    saved = activations._Softplus, activations._softplus_grad
    if version == "fused":
        class Fused:
            @staticmethod
            def apply(x, beta):
                return F.softplus(x, beta=beta,
                                  threshold=activations._THRESHOLD)
        activations._Softplus = Fused
    elif version == "two_pass":
        activations._softplus_grad = activations._softplus_grad_plain

    def undo():
        activations._Softplus, activations._softplus_grad = saved
    return undo


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--epochs", type=int, default=2,
                        help="timed epochs per version and round")
    parser.add_argument("--paths", nargs="+",
                        default=["default", "g256_bf16"])
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_softplus_step_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from ndjir_torch import kernels
    from ndjir_torch.ops import activations

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    chip_smoke.OUT_DIR = os.path.join(HERE, "chip_smoke_out",
                                      "softplus_cost")
    kernels.build()
    overrides = {"default": [], "g256_bf16": chip_smoke.OCTA}
    ms = {p: {v: [] for v in VERSIONS} for p in args.paths}
    for path in args.paths:
        trainer = chip_smoke.make_trainer(
            torch, [*overrides[path],
                    f"train.steps_per_call={chip_smoke.GRAPH_SPC}"],
            tag=f"monitor_softplus_{path}", views=chip_smoke.GRAPH_VIEWS)
        iters = trainer.ds.iters_per_epoch

        def epoch():
            trainer.train(stop_epoch=trainer.start_epoch + 1)
            torch.cuda.synchronize()
        for r in range(args.rounds):
            for version in VERSIONS:
                undo = use_version(version, activations, F)
                try:
                    trainer.graph.release()
                    torch.cuda.empty_cache()
                    epoch()     # warm-up step, capture, replays
                    for _ in range(args.epochs):
                        t0 = time.perf_counter()
                        epoch()
                        ms[path][version].append(
                            1e3 * (time.perf_counter() - t0) / iters)
                finally:
                    undo()
                got = ms[path][version][-args.epochs:]
                print(f"{path} round {r} {version}: "
                      f"{' '.join(f'{t:.1f}' for t in got)} ms/step "
                      f"captured", flush=True)
        if not all(m["grads_finite"] for m in trainer.history):
            print(f"{path}: a step non-finite", file=sys.stderr)
            return 1
        trainer.graph.release()
        del trainer
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "ms_per_step": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
