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
The opt-ins run as in the JAX package: fresh Monte-Carlo uniforms every
step (``renderer.fixed_graph_seeds: false``), the coarse-grid proposal and
its refresh cadence, rematerialized heads; ``parallel.mesh_shape`` other
than ``[1, 1]`` shards each batch over the ranks of ``torch.distributed``
(:mod:`ndjir_torch.parallel.mesh`).

:func:`train_steps` is the JAX package's fused K-step call: on the card the
replays of one captured step (:mod:`ndjir_torch.train.graph`; a sharded
step's collectives captured with it), on the CPU the same step as a loop.
``Trainer.train`` calls it for every call of ``train.steps_per_call``
steps (k > 1, sharded or not) after staging the call's K batches in one
copy and taking this rank's shard of them, and runs ``train_step``
eagerly at ``steps_per_call: 1``.  Neither waits on the
card: the non-finite skip is a select on the device, the schedule scalars
are device tensors, and the monitors stay on the device until one fetch at
the end of the epoch.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Callable, Dict, Optional

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
from ndjir_torch.parallel.mesh import ShardingPlan, ShardReducer
from ndjir_torch.render.image import render_image
from ndjir_torch.render.loss import total_loss
from ndjir_torch.render.renderer import make_mc_cdfs
from ndjir_torch.render.sampler import make_proposal_grid
from ndjir_torch.train import schedules
from ndjir_torch.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from ndjir_torch.train.graph import CapturedStep, device_scalars
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
from ndjir_torch.utils.profiling import annotate, set_step


def loss_and_grads(params, camloc, raydir, color_gt, obj_mask,
                   cos_anneal, lv_gain, conf, cdfs=None,
                   step=None, proposal_grid=None, reduce_counts=None):
    """(loss, detached monitors, grads): ``total_loss`` and its gradient
    with respect to every parameter leaf, as a tree shaped like
    ``params`` (zeros for a leaf the loss does not reach)."""
    leaves = list(tree_leaves_with_path(params))
    for _, p in leaves:
        p.requires_grad_(True)
    try:
        loss, monitors = total_loss(params, camloc, raydir, color_gt,
                                    obj_mask, cos_anneal, lv_gain, conf,
                                    cdfs=cdfs, step=step,
                                    proposal_grid=proposal_grid,
                                    reduce_counts=reduce_counts)
        with annotate("step.backward"):
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
               cos_anneal, lv_gain, lr_weight, lr_feat, conf, cdfs=None,
               step=None, proposal_grid=None,
               reducer: Optional[ShardReducer] = None
               ) -> Dict[str, torch.Tensor]:
    """One training step, updating ``params`` and ``opt_state`` in place,
    without waiting on the card.  The four schedule scalars are floats or
    0-dim f32 tensors.  Returns the loss monitors plus ``grads_finite``
    (False when a non-finite gradient skipped the update), all 0-dim
    tensors on the device.  ``step`` is the global step
    (fresh Monte-Carlo seeds fold it in when ``cdfs`` is None);
    ``proposal_grid`` the coarse-grid snapshot.  With a ``reducer`` the
    batch and ``cdfs`` are this rank's shard: the loss's counts and then
    the gradients are summed over the reducer's group, and the monitors
    are the whole batch's."""
    _, monitors, grads = loss_and_grads(
        params, camloc, raydir, color_gt, obj_mask, cos_anneal, lv_gain,
        conf, cdfs=cdfs, step=step, proposal_grid=proposal_grid,
        reduce_counts=None if reducer is None else reducer.counts)
    group = None
    if reducer is not None:
        grads = reducer.grads(grads)
        monitors = reducer.monitors(monitors)
        group = reducer.group
    with annotate("step.update"):
        monitors["grads_finite"] = apply_updates(
            params, grads, opt_state, lr_weight, lr_feat, conf, group=group)
    return monitors


def train_steps(params, opt_state, camloc, raydir, color_gt, obj_mask,
                cos_anneal, lv_gain, lr_weight, lr_feat, step0, conf,
                cdfs=None, proposal_grid=None,
                graph: Optional[CapturedStep] = None,
                reducer: Optional[ShardReducer] = None,
                step_cdfs: Optional[Callable[[int], Dict]] = None
                ) -> Dict[str, torch.Tensor]:
    """K training steps in one call (the JAX package's ``train_steps``,
    ndjir_tpu/train/trainer.py:62-95): the batch arrays carry a leading K
    axis, the schedule scalars, ``cdfs`` and ``proposal_grid`` are shared
    by the K steps, and step j is global step ``step0 + j``.  With
    ``cdfs`` None its uniforms are ``step_cdfs(step0 + j)``, by default
    ``make_mc_cdfs(..., step0 + j)`` of the batch's shape.  With a
    ``reducer`` the batches are this rank's shards (``ShardingPlan.
    shard_batch_steps``) and every step is :func:`train_step`'s sharded
    step; fresh uniforms then need ``step_cdfs``, this rank's shard of the
    whole batch's draw (``Trainer.step_cdfs``).  Updates ``params`` and
    ``opt_state`` in place and returns the monitors stacked along K.

    On a CUDA device the steps are replays of one captured ``train_step``,
    its collectives included (``graph``, a
    :class:`~ndjir_torch.train.graph.CapturedStep` kept by the caller
    across calls; a new one, captured for this call alone, when None).  On
    the CPU the same step runs as a loop."""
    K = camloc.shape[0]
    B, R = color_gt.shape[1:3]
    step0 = int(step0)
    if cdfs is None and step_cdfs is None:
        if reducer is not None:
            raise ValueError("a sharded train_steps with fresh uniforms "
                             "needs step_cdfs (this rank's shard of each "
                             "step's draw)")

        def step_cdfs(g):
            return make_mc_cdfs(conf, B, R, step=g, dtype=color_gt.dtype,
                                device=color_gt.device)

    if camloc.is_cuda:
        graph = graph if graph is not None else CapturedStep(train_step,
                                                             conf)
        return graph.run([(params, opt_state)],
                         [(camloc, raydir, color_gt, obj_mask)],
                         (cos_anneal, lv_gain, lr_weight, lr_feat),
                         cdfs, proposal_grid,
                         step_cdfs=None if cdfs is not None
                         else lambda j: step_cdfs(step0 + j),
                         reducer=reducer)[0]
    mons = [train_step(params, opt_state, camloc[j], raydir[j], color_gt[j],
                       obj_mask[j], cos_anneal, lv_gain, lr_weight, lr_feat,
                       conf, cdfs=cdfs if cdfs is not None
                       else step_cdfs(step0 + j),
                       step=step0 + j, proposal_grid=proposal_grid,
                       reducer=reducer)
            for j in range(K)]
    return {k: torch.stack([m[k] for m in mons]) for k in mons[0]}


def stage(arrays, device) -> list:
    """numpy float32 arrays as tensors on ``device``, all in one copy from
    pinned memory that does not wait on the card (on the CPU, the arrays'
    own memory)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    flat = np.concatenate([np.asarray(a, np.float32).reshape(-1)
                           for a in arrays])
    buf = torch.from_numpy(flat).pin_memory().to(device, non_blocking=True)
    out, off = [], 0
    for a in arrays:
        out.append(buf[off:off + a.size].view(a.shape))
        off += a.size
    return out


def fetch_monitors(mons) -> list:
    """Per step, {monitor: Python value}, from a list whose entries are one
    step's monitors (0-dim tensors) or a call's (stacked along K): one
    transfer from the device for all of them."""
    if not mons:
        return []
    names = list(mons[0])
    with annotate("train.fetch"):
        cols = torch.stack([torch.cat([m[k].float().reshape(-1)
                                       for m in mons])
                            for k in names]).cpu()
    return [{k: bool(v) if k == "grads_finite" else float(v)
             for k, v in zip(names, row)} for row in cols.t().tolist()]


def _is_dtu_data(data_path: str) -> bool:
    """reference: helper.py:137-138 (parent dir starts with 'DTU')."""
    parts = str(data_path).rstrip("/").split("/")
    return len(parts) >= 2 and parts[-2].startswith("DTU")


def check_supported(conf) -> None:
    """Refuse, before any work, what the port does not run: a grid
    encoding it does not know."""
    GridEncoding(conf.geometric_network.voxel)  # raises for an unknown type


def epoch_schedule(epoch: int, lr_w_base: float, lr_f_base: float, conf):
    """(lr_weight, lr_feat, cos_anneal_ratio, lv_gain) for ``epoch``.
    Reference parity: the schedules update at the END of epoch i
    (train.py:163), so epoch e trains with them at e-1, and epoch 0 with
    lr=0 / cos_anneal=0 / lv_gain=1 (solver.py:29)."""
    if epoch == 0:
        return 0.0, 0.0, 0.0, 1.0
    return (schedules.learning_rate(epoch - 1, lr_w_base, conf),
            schedules.learning_rate(epoch - 1, lr_f_base, conf),
            schedules.cos_anneal_ratio(epoch - 1, conf),
            schedules.light_visibility_gain(epoch - 1, conf))


def call_chunks(conf, iters: int):
    """(first iteration, step count) of each call of an epoch: the JAX
    package's ``steps_per_call`` grouping (trainer.py:250-292), capped at
    ``renderer.proposal_refresh_interval`` under the coarse-grid proposal.
    A refresh can fall only where a call starts."""
    spc = int(conf.train.get("steps_per_call", 1))
    if conf.renderer.get("proposal_method", "network") == "coarse_grid":
        spc = min(max(spc, 1), refresh_interval(conf))
    it = 0
    while it < iters:
        k = min(spc if spc > 0 else iters, iters - it)
        yield it, k
        it += k


def refresh_interval(conf) -> int:
    return int(conf.renderer.get("proposal_refresh_interval", 16))


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


def validate_scene(params, conf, ds, monitor_path: str, monitor_psnr,
                   monitor_image, epoch: int, final: bool = False,
                   chamfer: bool = True) -> None:
    """Render the ``valid.index`` view at ``valid.n_down_samples``, log
    its PSNR against the downsampled ground truth and the image, then
    extract the meshes (rough grid; full grid and mask trimming when
    ``final``); on a DTU scene (``DTU*/scanN``), when ``chamfer``, the
    final mesh's Chamfer distance against ``valid.dtumvs.ref_dir``
    (reference: train.py:114-118).  An extraction or Chamfer failure is
    logged and training goes on, as in the JAX package."""
    idx = conf.valid.index % ds.size
    pose = ds.poses[idx:idx + 1]
    intrinsic = ds.intrinsics[idx:idx + 1]
    rimage = render_image(params, pose, intrinsic, (ds.W, ds.H), conf,
                          lv_gain=schedules.light_visibility_gain(epoch,
                                                                  conf))
    dn = 2 ** conf.valid.n_down_samples
    gt = ds.images[idx][::dn, ::dn, :]
    gt = gt[np.newaxis].transpose(0, 3, 1, 2)
    h = min(gt.shape[2], rimage.shape[2])
    w = min(gt.shape[3], rimage.shape[3])
    monitor_image.add(epoch, rimage)
    monitor_psnr.add(epoch, psnr(rimage[:, :, :h, :w], gt[:, :, :h, :w]))
    try:
        fpath = extract_mesh_for_validation(params, conf, monitor_path, epoch,
                                            final=final, dataset=ds)
    except Exception as e:  # extraction must never kill training
        logger.exception(f"Mesh extraction failed (continuing): {e!r}")
        fpath = ""
    if chamfer and final and fpath and _is_dtu_data(conf.data_path):
        d = conf.valid.dtumvs
        d.mesh_path = fpath
        d.scan = str(conf.data_path).rstrip("/").split("/")[-1]
        d.vis_out_dir = monitor_path
        try:
            evaluate_by_chamfer(conf, dataset=ds)
        except Exception as e:  # scoring must never kill training
            logger.exception(f"Chamfer evaluation failed (continuing): "
                             f"{e!r}")


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
        """``parallel.mesh_shape`` other than ``[1, 1]`` needs
        ``torch.distributed`` set up with that many ranks: every rank
        builds a ``Trainer`` on the same data (the same batches), takes its
        shard of each, and starts from rank 0's parameters; rank 0 alone
        writes monitors, checkpoints and validations."""
        check_supported(conf)
        self.conf = conf
        self.device = torch.device(device)
        self.plan = ShardingPlan(conf)
        self.monitor_path = setup_monitor_dir(conf, train=self.plan.is_main)
        self.ckpt_dir = os.path.join(self.monitor_path, "checkpoints")
        self.ds = dataset if dataset is not None else IDRDataset.from_folder(
            conf, train=True, shuffle=True)
        self.params = init_model(conf, seed=seed, device=self.device)
        self.opt_state = init_optimizer(self.params)
        self.lr_w_base, self.lr_f_base = schedules.scaled_base_lrs(conf)
        # fixed graph seeds: the MC uniforms are the same every step, drawn
        # once; fresh seeds draw them per step (make_mc_cdfs(..., step))
        self.cdfs = None
        if conf.renderer.fixed_graph_seeds:
            self.cdfs = self.plan.shard_cdfs(make_mc_cdfs(
                conf, conf.train.batch_size, conf.train.n_rays,
                device=self.device))
        # the coarse-grid proposal's snapshot, refreshed on its cadence
        self.coarse_grid = (conf.renderer.get("proposal_method", "network")
                            == "coarse_grid")
        self.proposal_grid = None
        self.start_epoch = 0
        self.history = []  # per step: {monitor name: value}
        # the captured step of train_steps on the card, kept across calls
        self.graph = CapturedStep(train_step, conf)
        self._maybe_resume()
        if not self.plan.is_trivial:
            self.plan.broadcast(self.params)
            self.plan.broadcast(self.opt_state["mu"])
            self.plan.broadcast(self.opt_state["nu"])
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
        """:func:`validate_scene` of this trainer's scene."""
        validate_scene(self.params, self.conf, self.ds, self.monitor_path,
                       self.monitor_psnr, self.monitor_image, epoch, final)

    def _host_batch(self):
        B = self.conf.train.batch_size
        color, mask, intrinsic, pose, xy = self.ds.next_batch(B)
        raydir, camloc = generate_raydir_camloc(pose, intrinsic, xy)
        return camloc, raydir, color, mask

    def next_batch(self):
        """One training batch on the device: (camloc, raydir, color, mask)."""
        with annotate("train.batch", steps=1):
            return stage(self._host_batch(), self.device)

    def next_batches(self, k: int):
        """The next ``k`` training batches on the device, stacked (k, ...)
        and staged in one copy, as the JAX trainer stages a call's; this
        rank's shard of each (``ShardingPlan.shard_batch_steps``)."""
        with annotate("train.batch", steps=k):
            bs = [self._host_batch() for _ in range(k)]
            return self.plan.shard_batch_steps(
                *stage([np.stack(a) for a in zip(*bs)], self.device))

    def step_cdfs(self, gstep: int):
        """This rank's Monte-Carlo uniforms for global step ``gstep``."""
        if self.cdfs is not None:
            return self.cdfs
        conf = self.conf
        return self.plan.shard_cdfs(make_mc_cdfs(
            conf, conf.train.batch_size, conf.train.n_rays, step=gstep,
            device=self.device))

    def train(self, stop_epoch: Optional[int] = None):
        """Train epochs [start_epoch, stop_epoch) of the conf.train.epoch
        schedule (all of it by default), validating at the top of every
        ``valid.epoch_interval``-th epoch and saving a checkpoint after
        every ``train.checkpoint_interval_epochs``-th.  Reaching the end of
        the schedule saves the last checkpoint and runs the final
        validation.  Under the coarse-grid proposal the snapshot is rebuilt
        from the parameters at the start of every global step that is a
        multiple of ``renderer.proposal_refresh_interval`` and starts a
        call (:func:`call_chunks`), as in the JAX package.  A call of k > 1
        steps goes through :func:`train_steps` (the captured step on the
        card), sharded or not.  Under a profiler each epoch records the
        spans of :mod:`ndjir_torch.utils.profiling` (``train.epoch`` and
        its phases)."""
        conf = self.conf
        E = conf.train.epoch
        stop = E if stop_epoch is None else min(stop_epoch, E)
        main = self.plan.is_main
        for epoch in range(self.start_epoch, stop):
            set_step(epoch * self.ds.iters_per_epoch)
            with annotate("train.epoch"):
                self._train_epoch(epoch)
        self.start_epoch = stop
        if stop == E and main:
            with annotate("train.checkpoint"):
                save_checkpoint(self.ckpt_dir, E - 1, self.params,
                                self.opt_state,
                                keep=conf.train.keep_checkpoints)
            if not conf.valid.skip:
                with annotate("train.validate"):
                    self.validate(E - 1, final=True)
        return self.params

    def _train_epoch(self, epoch: int) -> None:
        """One epoch of :meth:`train`: the validation due at its top, its
        calls, the one fetch of its monitors, their series and log line,
        and the checkpoint due after it."""
        conf = self.conf
        every = conf.train.checkpoint_interval_epochs
        iters = self.ds.iters_per_epoch
        main = self.plan.is_main
        reducer = self.plan.reducer
        if (epoch != 0 and conf.valid.epoch_interval > 0
                and epoch % conf.valid.epoch_interval == 0
                and not conf.valid.skip and main):
            with annotate("train.validate"):
                self.validate(epoch)

        with annotate("train.schedule"):
            lr_w, lr_f, car, lvg = device_scalars(
                epoch_schedule(epoch, self.lr_w_base, self.lr_f_base, conf),
                self.device)
        epoch_mons = []
        for it0, k in call_chunks(conf, iters):
            g0 = epoch * iters + it0
            set_step(g0)
            if self.coarse_grid and g0 % refresh_interval(conf) == 0:
                self.proposal_grid = make_proposal_grid(self.params, conf)
            if k > 1:
                batches = self.next_batches(k)
                with annotate("train.call", steps=k):
                    epoch_mons.append(train_steps(
                        self.params, self.opt_state, *batches, car, lvg,
                        lr_w, lr_f, g0, conf, cdfs=self.cdfs,
                        proposal_grid=self.proposal_grid, graph=self.graph,
                        reducer=reducer, step_cdfs=self.step_cdfs))
                continue
            for j in range(k):
                set_step(g0 + j)
                batch = self.next_batch()
                with annotate("train.step", steps=1):
                    epoch_mons.append(train_step(
                        self.params, self.opt_state,
                        *self.plan.shard_batch(*batch), car, lvg, lr_w, lr_f,
                        conf, cdfs=self.step_cdfs(g0 + j), step=g0 + j,
                        proposal_grid=self.proposal_grid, reducer=reducer))

        fetched = fetch_monitors(epoch_mons)
        with annotate("train.monitors"):
            for it, m in enumerate(fetched):
                self.history.append(m)
                if not main:
                    continue
                gstep = epoch * iters + it
                for k, s in self.series.items():
                    s.add(gstep, m[k])
                if not m["grads_finite"]:
                    logger.info(f"Non-finite grads at epoch {epoch} iter "
                                f"{it} (update skipped)")
            if main:
                mean_loss = float(np.mean([m["loss"] for m in
                                           self.history[-iters:]]))
                logger.info(f"epoch {epoch}: loss={mean_loss:.6g}")
                self.monitor_time.add(epoch)
        if main and every > 0 and (epoch + 1) % every == 0:
            with annotate("train.checkpoint"):
                save_checkpoint(self.ckpt_dir, epoch, self.params,
                                self.opt_state,
                                keep=conf.train.keep_checkpoints)
