#!/usr/bin/env python3
"""Where does the PyTorch port's quality run part from the JAX package's?

    python3 scripts/torch_quality_diagnosis.py kernel [--out DIR]
    python3 scripts/torch_quality_diagnosis.py uniforms FILE.npz [--out DIR]
        [--init CKPT | --seed S] [--mlp-dtype float32]

Both run the configuration of ``scripts/torch_quality_benchmark.py`` (G=256
f32 grid, bf16 MLP, mask term, radius 0.75) on its v2 scene, on the card.

``kernel`` holds what the CPU tests against the JAX package cannot see, at
the run's own sizes: every grid scatter-add (B1, G=256, D=4: a denser
slab regime than the default G=512 one of ``chip_smoke.py``) of the first
ten epochs against its exact float64 sums, then one full-batch step
(B=4, R=512) on the card against the same step on the CPU, loss and every
gradient leaf, with f32 MLP operands and with the run's bf16 ones.

``uniforms`` trains and scores the v2 benchmark with the Monte-Carlo
uniforms read from FILE in place of the port's own draw; FILE is what
``scripts/jax_mc_uniforms.py`` writes, the JAX package's draw for this
configuration.  Initial weights stay the port's draw (seed 0, or
``--seed S``) unless ``--init CKPT`` names a flax-msgpack checkpoint (or
its ``.packed`` form) whose parameters replace them before the first
epoch, which still runs at lr=0: ``scripts/jax_init_checkpoint.py`` writes the JAX package's
``init_model(PRNGKey(0), conf)`` for this configuration.  ``--mlp-dtype
float32`` runs the MLPs on f32 operands in place of the benchmark's bf16.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_quality_benchmark as qb  # noqa: E402

# a full-batch step, card against CPU, by the MLP's precision: (loss rtol,
# gradient tolerance as a share of each leaf's largest entry).  With f32
# MLP operands the two differ by summation order only.  With bf16 operands
# the grid's gradient is not held: there two correct implementations that
# round in different places part by ~10% of its largest entry at 128 rays
# (tests/test_torch_slice_batch.py), and more at 2,048
TOLS = {"float32": (1e-4, 5e-2), "bfloat16": (2e-3, None)}
CHECK_EPOCHS = 10


def kernel(work: str) -> int:
    import torch

    from ndjir_torch.ops import scatter
    from ndjir_torch.train import schedules
    from ndjir_torch.train.optim import tree_leaves_with_path, tree_map
    from ndjir_torch.train.trainer import loss_and_grads

    trainer = qb.make_trainer(work, "v2")
    real = scatter.scatter_add_rows
    errs = []

    def checked(ids, vals, num_rows):
        out = real(ids, vals, num_rows)
        exact = scatter._scatter_add_rows_plain(ids, vals, num_rows,
                                                torch.float64)
        scale = exact.abs().max().item()
        errs.append(((out.double() - exact).abs().max().item(), scale,
                     ids.numel()))
        return out

    scatter.scatter_add_rows = checked
    try:
        t0 = time.perf_counter()
        trainer.train(stop_epoch=CHECK_EPOCHS)
        torch.cuda.synchronize()
    finally:
        scatter.scatter_add_rows = real
    worst = max(e / max(s, 1e-30) for e, s, _ in errs)
    print(f"[kernel] {len(errs)} scatter-adds of {errs[0][2]:,} updates "
          f"into {qb.GRID}^3 rows over {CHECK_EPOCHS} epochs "
          f"({time.perf_counter() - t0:.1f} s): worst |kernel - exact f64| "
          f"/ max|exact| {worst:.3g}", flush=True)

    camloc, raydir, color, mask = trainer.next_batch()
    conf = trainer.conf
    car = schedules.cos_anneal_ratio(CHECK_EPOCHS - 1, conf)
    lvg = schedules.light_visibility_gain(CHECK_EPOCHS - 1, conf)
    ok = all(e <= 1e-5 * s for e, s, _ in errs)
    for mlp_dtype in ("float32", "bfloat16"):
        conf.precision.mlp_dtype = mlp_dtype
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            loss, _, grads = loss_and_grads(
                tree_map(lambda v: v.to(dev), trainer.params),
                *[a.to(dev) for a in (camloc, raydir, color, mask)],
                car, lvg, conf,
                cdfs={k: [u.to(dev) for u in v] if isinstance(v, list)
                      else v.to(dev) for k, v in trainer.cdfs.items()})
            out[dev] = (float(loss), {p: g.cpu().double() for p, g in
                                      tree_leaves_with_path(grads)})
            print(f"[kernel] {mlp_dtype} MLP, full-batch step on {dev}: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        (loss_g, grads_g), (loss_c, grads_c) = out["cuda"], out["cpu"]
        rel = abs(loss_g / loss_c - 1)
        # per leaf: max |card - CPU| over the leaf's largest entry, and the
        # norm of the difference over the leaf's norm
        leaves = sorted(
            (((grads_g[p] - g).abs().max() / g.abs().max().clamp_min(1e-30)
              ).item(),
             ((grads_g[p] - g).norm() / g.norm().clamp_min(1e-30)).item(),
             "/".join(p)) for p, g in grads_c.items())[::-1]
        loss_tol, grad_tol = TOLS[mlp_dtype]
        within = rel <= loss_tol and (grad_tol is None
                                      or leaves[0][0] <= grad_tol)
        ok = ok and within
        print(f"[kernel] {mlp_dtype} MLP, full-batch step after "
              f"{CHECK_EPOCHS} epochs: loss {loss_g:.7g} on the card, "
              f"{loss_c:.7g} on the CPU (rel {rel:.3g}, tol {loss_tol}); "
              f"gradient leaves by max |card - CPU| / leaf max (tol "
              f"{grad_tol}), with |card - CPU| / |CPU|: " + "; ".join(
                  f"{n} {m:.3g}, {l2:.3g}" for m, l2, n in leaves[:4])
              + f"; {'within' if within else 'OUTSIDE'} the tolerances",
              flush=True)
    return 0 if ok else 1


def load_init(trainer, ckpt: str, work: str) -> None:
    """Copy the parameters of the checkpoint ``ckpt`` into ``trainer``'s,
    leaving its optimizer state fresh and its start epoch at 0."""
    from jax_init_checkpoint import unpack

    from ndjir_torch.train.checkpoint import load_checkpoint

    with open(ckpt, "rb") as f:
        buf = f.read()
    if ckpt.endswith(".packed"):
        # no manifest beside it: the step stays 0
        ckpt = os.path.join(work, "init.msgpack")
        with open(ckpt, "wb") as f:
            f.write(unpack(buf))
    load_checkpoint(ckpt, trainer.params)
    grid = trainer.params["geometric-network"]["grid"]["F"]
    print(f"initial weights from {ckpt}: the grid's mean "
          f"{grid.double().mean().item():.9g}, std "
          f"{grid.double().std().item():.9g}", flush=True)


def uniforms(path: str, work: str, init=None, mlp_dtype=None,
             seed: int = 0) -> int:
    import torch

    from ndjir_torch.train import trainer as ttrainer

    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}

    def jax_draw(conf, B, R, dtype=torch.float32, device="cuda"):
        def t(a):
            if a.shape[:2] != (B, R):
                raise ValueError(f"{path} holds {a.shape}, not ({B}, {R}, "
                                 "...)")
            return torch.from_numpy(a).to(device, dtype)
        ups = sorted((k for k in arrays if k.startswith("upsample_")),
                     key=lambda k: int(k.split("_")[1]))
        cdfs = {k: t(a) for k, a in arrays.items()
                if not k.startswith("upsample_")}
        cdfs["upsample"] = [t(arrays[k]) for k in ups]
        return cdfs

    ttrainer.make_mc_cdfs = jax_draw
    make_trainer = qb.make_trainer

    def make(work, scene_kind, seed=0, device="cuda", overrides=()):
        extra = list(overrides)
        if mlp_dtype:
            extra.append(f"precision.mlp_dtype={mlp_dtype}")
        trainer = make_trainer(work, scene_kind, seed, device, extra)
        if init and trainer.start_epoch == 0:
            load_init(trainer, init, work)
        return trainer

    qb.make_trainer = make
    return qb.main(["--scene", "v2", "--out", work, "--seed", str(seed)])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    k = sub.add_parser("kernel")
    k.add_argument("--out", default=os.path.join(
        REPO, "chip_smoke_out", "diagnosis_kernel"))
    u = sub.add_parser("uniforms")
    u.add_argument("file")
    u.add_argument("--out", default=os.path.join(
        REPO, "chip_smoke_out", "diagnosis_uniforms"))
    u.add_argument("--init", default=None,
                   help="flax-msgpack checkpoint (or its .packed form) "
                   "of the initial weights")
    u.add_argument("--mlp-dtype", choices=("bfloat16", "float32"),
                   default=None, help="the MLPs' operand dtype (default: "
                   "the benchmark's bfloat16)")
    u.add_argument("--seed", type=int, default=0,
                   help="seed of the port's own initial weights (not read "
                   "with --init)")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.cmd == "kernel":
        return kernel(os.path.abspath(args.out))
    return uniforms(args.file, os.path.abspath(args.out),
                    args.init and os.path.abspath(args.init), args.mlp_dtype,
                    args.seed)


if __name__ == "__main__":
    sys.exit(main())
