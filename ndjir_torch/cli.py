"""Command-line entry points (the port's counterpart of ``ndjir_tpu/cli.py``).

Usage (mirrors the reference's per-script CLIs, reference: python/train.py,
render_image.py, extract_by_mc.py, evaluate_*.py — unified as subcommands):

  python -m ndjir_torch.cli train   --config-name default data_path=DTU/scan65
  python -m ndjir_torch.cli render  --config-name default model_load_path=...
  python -m ndjir_torch.cli extract --config-name default model_load_path=...
  python -m ndjir_torch.cli eval-image    --config-name default ...
  python -m ndjir_torch.cli eval-chamfer  --config-name default ...
  python -m ndjir_torch.cli make-synthetic out_dir [n_views H W]

Trailing ``key.path=value`` arguments are hydra-style dotted overrides.
``--device`` (default ``cuda``) names the device that ``train``, ``render``
and ``extract`` run on; with no CUDA device they stop with an error unless
``--device cpu`` is given.  The evaluations are host code (numpy, scipy).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _load_conf(args):
    from ndjir_torch.config import load_config

    return load_config(args.config_name, overrides=args.overrides,
                       config_dir=args.config_path)


def _device(args):
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: no CUDA device is available; the port "
            "runs on an NVIDIA GPU (pass --device cpu to run on the CPU)")
    return device


def _load_params(conf, device):
    """The model of ``conf`` with the newest checkpoint at
    ``model_load_path`` (a checkpoint file, or a directory holding them or a
    ``checkpoints/`` directory) loaded into it; JAX- and port-written files
    alike."""
    from ndjir_torch.models.fields import init_model
    from ndjir_torch.train.checkpoint import latest_checkpoint, load_checkpoint

    params = init_model(conf, seed=0, device=device)
    path = conf.model_load_path
    if os.path.isdir(path):
        ck = latest_checkpoint(path) or latest_checkpoint(
            os.path.join(path, "checkpoints"))
    else:
        ck = path if os.path.exists(path) else None
    if ck is None:
        raise FileNotFoundError(
            f"No checkpoint at model_load_path={path!r}")
    params, _, _ = load_checkpoint(ck, params)
    return params


def cmd_train(args):
    conf = _load_conf(args)
    from ndjir_torch.train.trainer import Trainer

    Trainer(conf, device=_device(args)).train()


def cmd_render(args):
    conf = _load_conf(args)
    from ndjir_torch.data.dataset import IDRDataset
    from ndjir_torch.render.image import render_image
    from ndjir_torch.train.trainer import setup_monitor_dir
    from ndjir_torch.utils.png import write_png

    device = _device(args)
    monitor_path = setup_monitor_dir(conf, train=False)
    params = _load_params(conf, device)
    ds = IDRDataset.from_folder(conf, train=False)
    out_dir = os.path.join(monitor_path, "rendered")
    os.makedirs(out_dir, exist_ok=True)
    for i in range(ds.size):
        img = render_image(params, ds.poses[i:i + 1], ds.intrinsics[i:i + 1],
                           (ds.W, ds.H), conf)
        arr = (np.clip(img[0].transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
        write_png(os.path.join(out_dir, f"{i:06d}.png"), arr)
        dn = 2 ** conf.valid.n_down_samples
        m = ds.masks[i][::dn, ::dn]
        h = min(arr.shape[0], m.shape[0])
        w = min(arr.shape[1], m.shape[1])
        masked = (arr[:h, :w] * m[:h, :w]).astype(np.uint8)
        write_png(os.path.join(out_dir, f"{i:06d}_masked.png"), masked)
        print(f"rendered view {i}/{ds.size}")


def cmd_extract(args):
    conf = _load_conf(args)
    from ndjir_torch.data.dataset import IDRDataset
    from ndjir_torch.extract.mc import extract
    from ndjir_torch.train.trainer import setup_monitor_dir

    device = _device(args)
    monitor_path = setup_monitor_dir(conf, train=False)
    params = _load_params(conf, device)
    ds = IDRDataset.from_folder(conf, train=False)
    extract(params, conf, monitor_path, "mesh", dataset=ds, final=True)


def cmd_eval_image(args):
    conf = _load_conf(args)
    from ndjir_torch.eval.rendered import evaluate_rendered_images

    evaluate_rendered_images(conf)


def cmd_eval_chamfer(args):
    conf = _load_conf(args)
    from ndjir_torch.eval.chamfer import evaluate_by_chamfer

    evaluate_by_chamfer(conf)


def cmd_make_synthetic(args):
    from ndjir_torch.data.synthetic import make_synthetic_scene

    extra = [int(x) for x in args.overrides[:3]]
    n_views = extra[0] if len(extra) > 0 else 8
    H = extra[1] if len(extra) > 1 else 64
    W = extra[2] if len(extra) > 2 else 64
    make_synthetic_scene(args.out_dir, n_views=n_views, H=H, W=W)
    print(f"Wrote synthetic scene to {args.out_dir}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="ndjir_torch",
        description="Joint inverse rendering on an NVIDIA GPU (PyTorch + "
        "CUDA)")
    sub = parser.add_subparsers(dest="command", required=True)

    def add(name, fn, on_device=False):
        p = sub.add_parser(name)
        p.add_argument("--config-path", default=None)
        p.add_argument("--config-name", default="default")
        if on_device:
            p.add_argument("--device", default="cuda",
                           help="the device to run on (default: cuda)")
        p.add_argument("overrides", nargs="*", default=[])
        p.set_defaults(fn=fn)

    add("train", cmd_train, on_device=True)
    add("render", cmd_render, on_device=True)
    add("extract", cmd_extract, on_device=True)
    add("eval-image", cmd_eval_image)
    add("eval-chamfer", cmd_eval_chamfer)
    p = sub.add_parser("make-synthetic")
    p.add_argument("out_dir")
    p.add_argument("overrides", nargs="*", default=[])
    p.set_defaults(fn=cmd_make_synthetic)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
