#!/usr/bin/env python3
"""End-to-end quality benchmark of the PyTorch + CUDA port (``ndjir_torch``)
on the hard synthetic scene; the port's counterpart of
``scripts/quality_benchmark.py``.

    python3 scripts/torch_quality_benchmark.py [--scene v2|v1] [--out DIR]
        [--device cuda] [--seed S]

It writes the scene with the port's own writer
(``make_hard_synthetic_scene_v2`` by default: blobby SDF, procedural
texture, soft shadows and GGX specular, image-formed with the framework's
own physical model; ``--scene v1`` for the directional-light Blinn-Phong
scene), trains the same overrides as the JAX
script (G=256 f32 grid, bf16 MLP, ``train.mask_weight=0.1``, bounding sphere
0.75; 1200 epochs for v2, 400 for v1), and scores exactly as it does:

  - ``chamfer`` (``accuracy`` and ``completeness``): bidirectional mean
    nearest-neighbour distance between surface samples of the mesh
    extracted at 256^3 and of the ground-truth mesh (marching cubes of the
    scene's exact SDF lattice ``gt_sdf.npz``);
  - masked PSNR, SSIM and ``ssim_obj`` (mask-weighted SSIM) of view 0
    rendered at full resolution.

The scene is 24 views of 128x128, as the JAX script's.  Training saves a
checkpoint every 100 epochs under ``--out``, and a rerun resumes from the
newest one.  The result goes to ``<out>/quality_<scene>.json`` and, as the
last line, to standard output; ``wall_s`` sums the training time of every
run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

EPOCHS = {"v2": 1200, "v1": 400}
GRID, RES, VIEWS = 256, 128, 24
CHUNK = 100  # epochs between checkpoints


def chamfer_to_gt(verts, tris, gt_verts, gt_tris, n_samples=150_000, seed=0):
    """Bidirectional mean NN distance between surface samples:
    (chamfer, accuracy pred -> GT, completeness GT -> pred)."""
    from scipy.spatial import cKDTree

    from ndjir_torch.eval.chamfer import sample_tri_grid

    rng = np.random.RandomState(seed)

    def surf_points(v, t):
        pts = sample_tri_grid(v, t, 0.002)
        if len(pts) > n_samples:
            pts = pts[rng.choice(len(pts), n_samples, replace=False)]
        return pts

    p = surf_points(verts, tris)
    q = surf_points(gt_verts, gt_tris)
    d_pq = cKDTree(q).query(p, k=1)[0]   # accuracy: pred -> GT
    d_qp = cKDTree(p).query(q, k=1)[0]   # completeness: GT -> pred
    return (float((d_pq.mean() + d_qp.mean()) / 2.0),
            float(d_pq.mean()), float(d_qp.mean()))


def score(params, conf, ds, scene: str, grid: int = 256) -> dict:
    """The JAX script's scores of a trained model: view 0 at full
    resolution against the ground truth, and the ``grid``^3 mesh against
    the scene's ground-truth mesh."""
    from ndjir_torch.eval.image import psnr, ssim, ssim_masked
    from ndjir_torch.extract.mc import compute_sdf_volume, mesh_from_volume
    from ndjir_torch.render.image import render_image
    from ndjir_torch.train import schedules

    lvg = schedules.light_visibility_gain(conf.train.epoch - 1, conf)
    conf.valid.n_down_samples = 0
    img = render_image(params, ds.poses[0:1], ds.intrinsics[0:1],
                       (ds.W, ds.H), conf, lv_gain=lvg)
    pred = np.clip(img[0].transpose(1, 2, 0), 0, 1)
    gt = ds.images[0]
    mask = ds.masks[0]
    m3 = np.repeat(mask, 3, axis=-1) > 0.5
    psnr_masked = psnr(pred[None].transpose(0, 3, 1, 2),
                       gt[None].transpose(0, 3, 1, 2),
                       mask=m3[None].transpose(0, 3, 1, 2))
    ssim_v = ssim(pred, gt)
    # the SSIM map averaged with the window-mask overlap as weights: the
    # flat background's windows, ~60% of the image, count for nothing
    ssim_obj = ssim_masked(pred, gt, mask[..., 0] if mask.ndim == 3 else mask)

    vol = compute_sdf_volume(params, conf, grid)
    verts, tris = mesh_from_volume(vol, 0.0,
                                   conf.renderer.bounding_sphere_radius)
    with np.load(os.path.join(scene, "gt_sdf.npz")) as gt_npz:
        # the lattice spans the symmetric box [vmin, vmax]^3
        gv, gtris = mesh_from_volume(gt_npz["sdf"], 0.0,
                                     float(gt_npz["vmax"]))
    chamfer, acc, comp = chamfer_to_gt(verts, tris, gv, gtris)
    return dict(chamfer=round(chamfer, 6), accuracy=round(acc, 6),
                completeness=round(comp, 6),
                psnr_masked=round(float(psnr_masked), 3),
                ssim=round(float(ssim_v), 4),
                ssim_obj=round(float(ssim_obj), 4))


def make_trainer(work: str, scene_kind: str, seed: int = 0,
                 device="cuda", overrides=()):
    """The benchmark's ``Trainer`` on its scene, ``<work>/scene``, which is
    written first when it is missing; it resumes from the newest
    checkpoint under ``<work>/run_scene``.  ``overrides`` (dotted, after
    the benchmark's own) are for ``scripts/torch_quality_diagnosis.py``."""
    from ndjir_torch.config import load_config
    from ndjir_torch.data.synthetic import (
        make_hard_synthetic_scene,
        make_hard_synthetic_scene_v2,
    )
    from ndjir_torch.train.trainer import Trainer

    scene = os.path.join(work, "scene")
    if not os.path.exists(os.path.join(scene, "gt_sdf.npz")):
        t0 = time.perf_counter()
        make_scene = (make_hard_synthetic_scene_v2 if scene_kind == "v2"
                      else make_hard_synthetic_scene)
        make_scene(scene, n_views=VIEWS, H=RES, W=RES)
        print(f"wrote the {scene_kind} scene in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    conf = load_config("default", overrides=[
        f"data_path={scene}",
        f"monitor_base_path={work}/run",
        f"geometric_network.voxel.grid_size={GRID}",
        "precision.mlp_dtype=bfloat16",
        f"train.epoch={EPOCHS[scene_kind]}",
        # synthetic low-texture scenes need the mask term (the reference's
        # objmask.yaml preset)
        "train.mask_weight=0.1",
        "renderer.bounding_sphere_radius=0.75",
        "valid.skip=true",
        f"train.checkpoint_interval_epochs={CHUNK}",
        "train.keep_checkpoints=2",
        # the JAX package's fused dispatch (scripts/quality_benchmark.py:
        # 119): on the card, replays of one captured step
        "train.steps_per_call=8",
        *overrides,
    ])
    return Trainer(conf, device=device, seed=seed)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scene", choices=sorted(EPOCHS), default="v2")
    parser.add_argument("--out", default=None,
                        help="work directory (default: chip_smoke_out/"
                        "quality_<scene> in the repo)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the initial weights (the data order "
                        "and the Monte-Carlo uniforms are the config's)")
    args = parser.parse_args(argv)

    import torch

    cuda = torch.device(args.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 1
    epochs = EPOCHS[args.scene]
    work = os.path.abspath(args.out or os.path.join(
        REPO, "chip_smoke_out", f"quality_{args.scene}"))
    trainer = make_trainer(work, args.scene, args.seed, args.device)
    conf = trainer.conf
    wall_path = os.path.join(work, "wall_s.json")
    wall = 0.0
    if os.path.exists(wall_path):
        with open(wall_path) as f:
            wall = json.load(f)["wall_s"]
    while trainer.start_epoch < epochs:
        t0 = time.perf_counter()
        trainer.train(stop_epoch=(trainer.start_epoch // CHUNK + 1) * CHUNK)
        if cuda:
            torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        with open(wall_path, "w") as f:
            json.dump({"wall_s": wall, "epoch": trainer.start_epoch}, f)
        last = trainer.history[-1]
        print(f"epoch {trainer.start_epoch}/{epochs}: loss "
              f"{last['loss']:.6g}, {wall:.1f} s of training so far",
              flush=True)

    t0 = time.perf_counter()
    result = score(trainer.params, conf, trainer.ds, conf.data_path,
                   GRID)
    result.update(scene=args.scene, epochs=epochs, grid=GRID, res=RES,
                  views=VIEWS, seed=args.seed, wall_s=round(wall, 1),
                  score_s=round(time.perf_counter() - t0, 1),
                  device=torch.cuda.get_device_name(0) if cuda else "cpu")
    with open(os.path.join(work, f"quality_{args.scene}.json"), "w") as f:
        json.dump(result, f)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
