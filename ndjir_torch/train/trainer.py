"""Per-scene training driver (counterpart of ``ndjir_tpu/train/trainer.py``;
reference python/train.py:33-165).

:func:`train_step` is one gradient step: sample -> render -> loss ->
autograd (with the eikonal double backward) -> dual Adam.  :class:`Trainer`
reads the IDR scene folder at ``data_path`` (or takes a dataset built from
arrays), feeds the step ray batches and the epoch schedules, validates (a
rendered view's PSNR and a mesh extraction; on a DTU scene the final one
also scores the mesh's Chamfer distance) on the ``valid`` cadence, saves
checkpoints on ``train.checkpoint_interval_epochs`` and at the end of the
schedule, and resumes from the newest checkpoint in its monitor directory.
Not ported yet, and refused with ``NotImplementedError`` where a config asks
for them: the opt-ins of ROADMAP A13 and multi-device sharding (A14).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from ndjir_torch.config import Config, save_config
from ndjir_torch.data.cameras import generate_raydir_camloc
from ndjir_torch.data.dataset import IDRDataset
from ndjir_torch.eval.chamfer import evaluate_by_chamfer
from ndjir_torch.eval.image import psnr
from ndjir_torch.extract.mc import extract_mesh_for_validation
from ndjir_torch.models.fields import init_model
from ndjir_torch.ops.grid import GridEncoding
from ndjir_torch.render.image import render_image
from ndjir_torch.render.loss import total_loss
from ndjir_torch.render.renderer import make_mc_cdfs
from ndjir_torch.train import schedules
from ndjir_torch.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from ndjir_torch.train.optim import (
    apply_updates,
    init_optimizer,
    tree_leaves_with_path,
)
from ndjir_torch.utils.monitor import (
    Monitor,
    MonitorImage,
    MonitorSeries,
    MonitorTimeElapsed,
    logger,
)


def loss_and_grads(params, camloc, raydir, color_gt, obj_mask,
                   cos_anneal: float, lv_gain: float, conf, cdfs=None):
    """(loss, detached monitors, grads): ``total_loss`` and its gradient
    with respect to every parameter leaf, as a tree shaped like
    ``params`` (zeros for a leaf the loss does not reach)."""
    leaves = list(tree_leaves_with_path(params))
    for _, p in leaves:
        p.requires_grad_(True)
    try:
        loss, monitors = total_loss(params, camloc, raydir, color_gt,
                                    obj_mask, cos_anneal, lv_gain, conf,
                                    cdfs=cdfs)
        gs = torch.autograd.grad(loss, [p for _, p in leaves],
                                 allow_unused=True)
    finally:
        for _, p in leaves:
            p.requires_grad_(False)
    grads: Dict[str, Any] = {}
    for (path, p), g in zip(leaves, gs):
        node = grads
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.zeros_like(p) if g is None else g
    monitors = {k: v.detach() for k, v in monitors.items()}
    return loss.detach(), monitors, grads


def train_step(params, opt_state, camloc, raydir, color_gt, obj_mask,
               cos_anneal: float, lv_gain: float, lr_weight: float,
               lr_feat: float, conf, cdfs=None) -> Dict[str, torch.Tensor]:
    """One training step, updating ``params`` and ``opt_state`` in place.
    Returns the loss monitors plus ``grads_finite`` (False when a
    non-finite gradient skipped the update)."""
    _, monitors, grads = loss_and_grads(params, camloc, raydir, color_gt,
                                        obj_mask, cos_anneal, lv_gain, conf,
                                        cdfs=cdfs)
    finite = apply_updates(params, grads, opt_state, lr_weight, lr_feat, conf)
    monitors["grads_finite"] = torch.tensor(finite)
    return monitors


def _is_dtu_data(data_path: str) -> bool:
    """reference: helper.py:137-138 (parent dir starts with 'DTU')."""
    parts = str(data_path).rstrip("/").split("/")
    return len(parts) >= 2 and parts[-2].startswith("DTU")


def check_supported(conf) -> None:
    """Refuse, before any work, what the port does not run yet."""
    GridEncoding(conf.geometric_network.voxel)  # raises for an unknown type
    if list(conf.parallel.mesh_shape) != [1, 1]:
        raise NotImplementedError(
            "multi-device sharding is not ported yet (ROADMAP A14: "
            "parallel); set parallel.mesh_shape=[1,1]")
    if conf.train.get("remat_heads", False):
        raise NotImplementedError(
            "train.remat_heads is not ported yet (ROADMAP A13: precision "
            "and opt-ins)")
    if conf.renderer.get("proposal_method", "network") != "network":
        raise NotImplementedError(
            "renderer.proposal_method=coarse_grid is not ported yet "
            "(ROADMAP A13: precision and opt-ins)")


def setup_monitor_dir(conf, train: bool = True) -> str:
    """<monitor_base>_<scene>, set as ``conf.monitor_path``; for training,
    create it and snapshot the config and the port's code there (reference:
    helper.py:99-124)."""
    scene = str(conf.data_path).rstrip("/").split("/")[-1]
    monitor_path = f"{conf.monitor_base_path}_{scene}"
    conf.monitor_path = monitor_path
    if train:
        os.makedirs(monitor_path, exist_ok=True)
        save_config(conf, os.path.join(monitor_path, "config.yaml"))
        src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        shutil.copytree(src, os.path.join(monitor_path, "code",
                                          "ndjir_torch"),
                        dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__", "*.pyc",
                                                      "build"))
    return monitor_path


class Trainer:
    _SERIES = {"loss": "Training loss", "loss_rgb": "RGB loss",
               "loss_eikonal": "Eikonal loss", "loss_tv": "TV loss",
               "loss_mask": "Mask loss",
               "prior_base_color": "Base color prior",
               "prior_roughness": "Roughness prior",
               "prior_specular_reflectance": "Specular reflectance prior",
               "reg_std_roughness": "Std roughness reg",
               "reg_std_specular_reflectance": "Std specular reflectance reg",
               "gain": "Gain"}

    def __init__(self, conf: Config, dataset: Optional[IDRDataset] = None,
                 device="cuda", seed: int = 0):
        check_supported(conf)
        self.conf = conf
        self.device = torch.device(device)
        self.monitor_path = setup_monitor_dir(conf)
        self.ckpt_dir = os.path.join(self.monitor_path, "checkpoints")
        self.ds = dataset if dataset is not None else IDRDataset.from_folder(
            conf, train=True, shuffle=True)
        self.params = init_model(conf, seed=seed, device=self.device)
        self.opt_state = init_optimizer(self.params)
        self.lr_w_base, self.lr_f_base = schedules.scaled_base_lrs(conf)
        # fixed graph seeds: the MC uniforms are the same every step
        self.cdfs = make_mc_cdfs(conf, conf.train.batch_size,
                                  conf.train.n_rays, device=self.device)
        self.start_epoch = 0
        self.history = []  # per step: {monitor name: value}
        self._maybe_resume()
        m = Monitor(self.monitor_path)
        self.series = {k: MonitorSeries(n, m, verbose=False)
                       for k, n in self._SERIES.items()}
        self.monitor_time = MonitorTimeElapsed("Training time", m)
        Wl = self.ds.W // 2 ** conf.valid.n_down_samples
        Hl = self.ds.H // 2 ** conf.valid.n_down_samples
        self.monitor_psnr = MonitorSeries(f"PSNR {Wl}x{Hl}", m)
        self.monitor_image = MonitorImage(f"Rendered image {Wl}x{Hl}", m)

    def _maybe_resume(self):
        """Continue from the newest checkpoint in the monitor directory:
        parameters, optimizer state and the epoch after the saved one."""
        latest = latest_checkpoint(self.ckpt_dir)
        if latest:
            self.params, self.opt_state, extra = load_checkpoint(
                latest, self.params, self.opt_state)
            self.start_epoch = int(extra.get("step", 0)) + 1
            logger.info(f"Resumed from {latest} at epoch {self.start_epoch}")

    def validate(self, epoch: int, final: bool = False):
        """Render the ``valid.index`` view at ``valid.n_down_samples``, log
        its PSNR against the downsampled ground truth and the image, then
        extract the meshes (rough grid; full grid and mask trimming when
        ``final``); on a DTU scene (``DTU*/scanN``) the final mesh's Chamfer
        distance against ``valid.dtumvs.ref_dir`` (reference:
        train.py:114-118).  An extraction or Chamfer failure is logged and
        training goes on, as in the JAX package."""
        conf = self.conf
        idx = conf.valid.index % self.ds.size
        pose = self.ds.poses[idx:idx + 1]
        intrinsic = self.ds.intrinsics[idx:idx + 1]
        rimage = render_image(self.params, pose, intrinsic,
                              (self.ds.W, self.ds.H), conf,
                              lv_gain=schedules.light_visibility_gain(
                                  epoch, conf))
        dn = 2 ** conf.valid.n_down_samples
        gt = self.ds.images[idx][::dn, ::dn, :]
        gt = gt[np.newaxis].transpose(0, 3, 1, 2)
        h = min(gt.shape[2], rimage.shape[2])
        w = min(gt.shape[3], rimage.shape[3])
        self.monitor_image.add(epoch, rimage)
        self.monitor_psnr.add(epoch, psnr(rimage[:, :, :h, :w],
                                          gt[:, :, :h, :w]))
        try:
            fpath = extract_mesh_for_validation(
                self.params, conf, self.monitor_path, epoch, final=final,
                dataset=self.ds)
        except Exception as e:  # extraction must never kill training
            logger.exception(f"Mesh extraction failed (continuing): {e!r}")
            fpath = ""
        if final and fpath and _is_dtu_data(conf.data_path):
            d = conf.valid.dtumvs
            d.mesh_path = fpath
            d.scan = str(conf.data_path).rstrip("/").split("/")[-1]
            d.vis_out_dir = self.monitor_path
            try:
                evaluate_by_chamfer(conf, dataset=self.ds)
            except Exception as e:  # scoring must never kill training
                logger.exception(f"Chamfer evaluation failed (continuing): "
                                 f"{e!r}")

    def next_batch(self):
        """One training batch on the device: (camloc, raydir, color, mask)."""
        B = self.conf.train.batch_size
        color, mask, intrinsic, pose, xy = self.ds.next_batch(B)
        raydir, camloc = generate_raydir_camloc(pose, intrinsic, xy)
        return [torch.from_numpy(a).to(self.device)
                for a in (camloc, raydir, color, mask)]

    def train(self, stop_epoch: Optional[int] = None):
        """Train epochs [start_epoch, stop_epoch) of the conf.train.epoch
        schedule (all of it by default), validating at the top of every
        ``valid.epoch_interval``-th epoch and saving a checkpoint after
        every ``train.checkpoint_interval_epochs``-th.  Reaching the end of
        the schedule saves the last checkpoint and runs the final
        validation.  ``train.steps_per_call`` fuses steps into one program
        in the reference; here every step is its own call, the same math."""
        conf = self.conf
        E = conf.train.epoch
        stop = E if stop_epoch is None else min(stop_epoch, E)
        every = conf.train.checkpoint_interval_epochs
        iters = self.ds.iters_per_epoch
        for epoch in range(self.start_epoch, stop):
            if (epoch != 0 and conf.valid.epoch_interval > 0
                    and epoch % conf.valid.epoch_interval == 0
                    and not conf.valid.skip):
                self.validate(epoch)

            # reference parity: the schedules update at the END of epoch i
            # (train.py:163), so epoch e trains with them at e-1, and epoch 0
            # with lr=0 / cos_anneal=0 / lv_gain=1 (solver.py:29)
            if epoch == 0:
                lr_w = lr_f = 0.0
                car, lvg = 0.0, 1.0
            else:
                lr_w = schedules.learning_rate(epoch - 1, self.lr_w_base, conf)
                lr_f = schedules.learning_rate(epoch - 1, self.lr_f_base, conf)
                car = schedules.cos_anneal_ratio(epoch - 1, conf)
                lvg = schedules.light_visibility_gain(epoch - 1, conf)

            epoch_mons = []
            for _ in range(iters):
                camloc, raydir, color, mask = self.next_batch()
                epoch_mons.append(train_step(
                    self.params, self.opt_state, camloc, raydir, color, mask,
                    car, lvg, lr_w, lr_f, conf, cdfs=self.cdfs))

            for it, m in enumerate(epoch_mons):
                m = {k: v.item() for k, v in m.items()}
                self.history.append(m)
                gstep = epoch * iters + it
                for k, s in self.series.items():
                    s.add(gstep, m[k])
                if not m["grads_finite"]:
                    logger.info(f"Non-finite grads at epoch {epoch} iter "
                                f"{it} (update skipped)")
            mean_loss = float(np.mean([m["loss"] for m in
                                       self.history[-len(epoch_mons):]]))
            logger.info(f"epoch {epoch}: loss={mean_loss:.6g}")
            self.monitor_time.add(epoch)
            if every > 0 and (epoch + 1) % every == 0:
                save_checkpoint(self.ckpt_dir, epoch, self.params,
                                self.opt_state,
                                keep=conf.train.keep_checkpoints)
        self.start_epoch = stop
        if stop == E:
            save_checkpoint(self.ckpt_dir, E - 1, self.params,
                            self.opt_state, keep=conf.train.keep_checkpoints)
            if not conf.valid.skip:
                self.validate(E - 1, final=True)
        return self.params
