#!/usr/bin/env python3
"""How the grid encodings' parity checks fare as the grid is let into the
network.

    python3 scripts/torch_grid_rows_sweep.py card   # on one NVIDIA GPU
    python3 scripts/torch_grid_rows_sweep.py ulp    # on the CPU

The geometric init zeroes the weight rows that read the grid features, so
at initialisation the grid queries reach neither the loss nor the view.
``chip_smoke.py`` phase 10 draws those rows at a scale (``open_grid_rows``:
N(0, (scale * s)^2), s the std of the layer's other rows) before it holds
the card against the CPU.  For the presets ``custom``, ``triplaneline``
and ``voxel_hash`` at their published widths and each scale:

- ``card``: the loss and every gradient leaf of one small batch (B=2, R=4)
  on the card against the CPU (the grid leaves' largest difference over
  their largest entry), the queries' term in each grid leaf's gradient
  (how far it moves from the closed rows' one, over the closed one's
  largest entry, which is the TV term's),
  and ``chip_smoke.py``'s render parity (16x16 view, 32^3 SDF volume) at
  the scales in ``--render``.
- ``ulp``: on the CPU alone, how far a rendered view (image, normal, mask)
  moves when the camera pose moves by one ulp, and how far it lies from
  the closed rows' view: the render's own conditioning at that scale.
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ("custom", "triplaneline", "voxel_hash")


def card(torch, np, cs, presets, scales, render_scales):
    from ndjir_torch import kernels
    from ndjir_torch.config import load_config
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.render.renderer import make_mc_cdfs
    from ndjir_torch.train.optim import tree_leaves_with_path, tree_map
    from ndjir_torch.train.trainer import loss_and_grads

    kernels.build()
    B, R = 2, 4
    for preset in presets:
        conf = load_config(preset)
        rng = np.random.RandomState(7)
        camloc = np.tile(np.asarray([[0.1, -0.2, 2.5]], np.float32), (B, 1))
        raydir = rng.randn(B, R, 3).astype(np.float32) \
            - np.asarray([0.0, 0.0, 3.0], np.float32)
        raydir /= np.linalg.norm(raydir, axis=-1, keepdims=True)
        color = rng.rand(B, R, 3).astype(np.float32)
        mask = np.ones((B, R, 1), np.float32)
        batch = [torch.from_numpy(a) for a in (camloc, raydir, color, mask)]
        base = init_model(conf, seed=0, device="cpu")
        cdfs = make_mc_cdfs(conf, B, R, device="cpu")

        def run(params, device):
            cd = {k: [u.to(device) for u in v] if isinstance(v, list)
                  else v.to(device) for k, v in cdfs.items()}
            loss, _, grads = loss_and_grads(
                tree_map(lambda v: v.to(device), params),
                *[a.to(device) for a in batch], 0.37, 0.9, conf, cdfs=cd)
            return float(loss), {p: g.cpu()
                                 for p, g in tree_leaves_with_path(grads)}
        closed = None
        for scale in (0.0, *scales):
            t0 = time.time()
            params = tree_map(lambda v: v.clone(), base)
            if scale:
                cs.open_grid_rows(torch, params, conf, scale)
            loss_c, g_cpu = run(params, "cpu")
            loss_g, g_card = run(params, "cuda")
            closed = closed or g_cpu

            def rel(a, b, p):
                return float((a[p].double() - b[p].double()).abs().max()) \
                    / (float(b[p].abs().max()) + 1e-12)
            grid = {"/".join(p[2:]): (rel(g_card, g_cpu, p),
                                      rel(g_cpu, closed, p))
                    for p in g_cpu if "grid" in p}
            other = max((rel(g_card, g_cpu, p), "/".join(p))
                        for p in g_cpu if "grid" not in p)
            print(f"{preset} scale={scale}: loss {loss_c:.7g} (card rel "
                  f"{abs(loss_g / loss_c - 1):.2e}); grid leaf: (card vs "
                  f"CPU, queries' term over TV's) " + ", ".join(
                      f"{k} ({a:.2e}, {b:.3f})" for k, (a, b) in grid.items())
                  + f"; worst other leaf {other[0]:.2e} {other[1]} "
                  f"({time.time() - t0:.0f} s)", flush=True)
            if scale in render_scales:
                try:
                    cs.render_parity_phase(
                        torch, np, f"{preset} f32", config=preset, base=(),
                        spec=cs.RENDER_PARITY["f32"], grid_rows=scale)
                except AssertionError as e:
                    print(f"{preset} scale={scale}: render parity fails: {e}",
                          flush=True)
            del params, g_cpu, g_card
            gc.collect()
            torch.cuda.empty_cache()


def ulp(torch, np, cs, presets, scales):
    from ndjir_torch.config import load_config
    from ndjir_torch.data.dataset import IDRDataset
    from ndjir_torch.data.synthetic import render_sphere_scene
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.render import image
    from ndjir_torch.train.optim import tree_map

    images, masks, cameras = render_sphere_scene(n_views=2, H=64, W=64)
    real = image.make_mc_cdfs
    for preset in presets:
        conf = load_config(preset, overrides=["valid.n_down_samples=2"])
        ds = IDRDataset(conf, images, masks, cameras, train=False,
                        shuffle=False)
        base = init_model(conf, seed=0, device="cpu")
        P = min(conf.valid.n_rays, 16 * 16)
        cdfs = real(image.chunk_conf(conf), 1, P, device="cpu")
        image.make_mc_cdfs = lambda *a, **k: cdfs
        pose = ds.poses[:1]
        shifted = np.nextafter(pose, np.float32(10))
        try:
            closed = None
            for scale in (0.0, *scales):
                params = tree_map(lambda v: v.clone(), base)
                if scale:
                    cs.open_grid_rows(torch, params, conf, scale)
                views = [image.render_image(params, p, ds.intrinsics[:1],
                                            (64, 64), conf, return_aux=True)
                         for p in (pose, shifted)]
                closed = closed or views[0]

                def diff(a, b):
                    return ", ".join(f"{n} {np.abs(x - y).max():.2e}"
                                     for n, x, y in zip(
                                         ("image", "normal", "mask"), a, b))
                print(f"{preset} scale={scale}: pose + 1 ulp moves the view "
                      f"by {diff(*views)}; from the closed rows' view "
                      f"{diff(views[0], closed)}", flush=True)
        finally:
            image.make_mc_cdfs = real


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("mode", choices=("card", "ulp"))
    parser.add_argument("--presets", nargs="+", default=list(PRESETS),
                        choices=PRESETS)
    parser.add_argument("--scales", type=float, nargs="+",
                        default=[0.0003, 0.001, 0.003, 0.01, 0.03, 0.1])
    parser.add_argument("--render", type=float, nargs="*",
                        default=[0.01, 0.1],
                        help="card mode: the scales whose render parity "
                        "is tried")
    args = parser.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs

    if args.mode == "card":
        if not torch.cuda.is_available():
            print("card mode needs an NVIDIA GPU", file=sys.stderr)
            return 1
        card(torch, np, cs, args.presets, args.scales, args.render)
    else:
        ulp(torch, np, cs, args.presets, args.scales)
    return 0


if __name__ == "__main__":
    sys.exit(main())
