"""Train several scenes at once (counterpart of the JAX package's
``parallel/multi_scene.py``).

S scenes, each with its own parameters and optimizer state.  With
``parallel.mesh_shape = [data, rays]`` the scenes split over the ``data``
axis (S divisible by it; row ``d`` of the mesh trains scenes
``d*S/data ... (d+1)*S/data - 1``) and each scene's rays over the ``rays``
axis, the loss's counts and the gradients summed over the row
(:mod:`ndjir_torch.parallel.mesh`).  Parameters never meet across scenes.

The JAX package stacks the scenes on a leading axis and vmaps one step over
it.  Here each scene keeps its own tree and the step loops over them: one
default scene's step (B=4 x R=512 x 128 samples) already fills an H100,
and a vmap would need batching rules for the scatter and fold kernels
(``autograd.Function``s over ``ctypes`` calls) and the eikonal double
backward.  The scenes are stacked only in a checkpoint,
``<monitor_base>_multiscene/checkpoints``: every leaf ``(S, ...)`` in
scene order, the step counts ``(S,)``, and the scene list in the manifest,
the JAX package's layout, so each package resumes the other's.

Initial weights: scene ``i`` draws ``init_model(conf, seed=seed + i)``
(``seed`` 0 by default), so scene 0 starts where a single-scene
``Trainer`` does.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ndjir_torch.config import Config
from ndjir_torch.data.cameras import generate_raydir_camloc
from ndjir_torch.data.dataset import IDRDataset
from ndjir_torch.models.fields import init_model
from ndjir_torch.parallel.mesh import ShardingPlan, ShardReducer
from ndjir_torch.render.renderer import make_mc_cdfs
from ndjir_torch.train import schedules
from ndjir_torch.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from ndjir_torch.train.optim import init_optimizer, tree_leaves_with_path
from ndjir_torch.train.trainer import (
    Trainer,
    check_supported,
    epoch_schedule,
    setup_monitor_dir,
    train_step,
    validate_scene,
)
from ndjir_torch.utils.monitor import (
    Monitor,
    MonitorImage,
    MonitorSeries,
    MonitorTimeElapsed,
    logger,
)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> None:
    """Join the process group: ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them)
    with no ``coordinator``, else ``tcp://<coordinator>`` with the given
    world size and rank.  NCCL for ``device="cuda"`` (each process takes
    card ``rank % device_count``), gloo for ``"cpu"``.  A second call is a
    no-op."""
    if dist.is_initialized():
        return
    cuda = torch.device(device).type == "cuda"
    backend = "nccl" if cuda else "gloo"
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    if cuda:
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    logger.info(f"distributed: rank {dist.get_rank()} / "
                f"{dist.get_world_size()} ({backend})")


def multi_scene_train_step(params_list, opt_states, camloc, raydir, color_gt,
                           obj_mask, cos_anneal: float, lv_gain: float,
                           lr_weight: float, lr_feat: float, step: int, conf,
                           cdfs=None,
                           reducer: Optional[ShardReducer] = None
                           ) -> List[Dict[str, torch.Tensor]]:
    """One :func:`train_step` per scene, in place on each scene's
    parameters and optimizer state.  The batch arrays are per scene,
    ``camloc[s]`` (B, 3) and the others (B, R, .); ``cdfs`` are shared by
    the scenes (the JAX package draws one set per step).  Returns each
    scene's monitors."""
    return [train_step(p, o, camloc[s], raydir[s], color_gt[s], obj_mask[s],
                       cos_anneal, lv_gain, lr_weight, lr_feat, conf,
                       cdfs=cdfs, step=step, reducer=reducer)
            for s, (p, o) in enumerate(zip(params_list, opt_states))]


def _stack_like(tree, S: int):
    """CPU tensors of shape (S, *leaf.shape), the tree of ``tree``."""
    return {k: _stack_like(v, S) if isinstance(v, dict)
            else torch.empty((S, *v.shape), dtype=v.dtype)
            for k, v in tree.items()}


class MultiSceneTrainer:
    """Train the scenes of ``scene_paths`` together; see the module
    docstring for the layout.  Per scene, as the single-scene
    :class:`~ndjir_torch.train.trainer.Trainer`: a monitor directory
    ``<monitor_base>_<scene>`` with the same series, validation (render,
    PSNR, meshes) through :meth:`scene_params`, and NaN-skip; one stacked
    checkpoint for all, which resume refuses for another scene list.
    Monitors and validations are written by the first rank of each row."""

    def __init__(self, conf: Config, scene_paths: List[str],
                 datasets: Optional[List[IDRDataset]] = None,
                 device="cuda", seed: int = 0):
        check_supported(conf)
        self.conf = conf
        self.device = torch.device(device)
        self.scene_paths = [str(p) for p in scene_paths]
        S = len(scene_paths)
        self.plan = plan = ShardingPlan(conf)
        if S % plan.shape[0]:
            raise ValueError(f"{S} scenes do not split over the data axis "
                             f"of mesh_shape {list(plan.shape)}")
        per = S // plan.shape[0]
        self.local = list(range(plan.data_index * per,
                                (plan.data_index + 1) * per))
        self.writes = plan.ray_index == 0  # monitors of this row's scenes

        self.scene_confs, self.monitor_paths = [], []
        for p in self.scene_paths:
            c = Config(conf.to_dict())
            c.data_path = p
            self.monitor_paths.append(setup_monitor_dir(
                c, train=plan.is_main))
            self.scene_confs.append(c)
        self.datasets = datasets if datasets is not None else [
            IDRDataset.from_folder(c, train=True, shuffle=True)
            for c in self.scene_confs]

        self.params = [init_model(conf, seed=seed + i, device=self.device)
                       for i in self.local]
        self.opt_states = [init_optimizer(p) for p in self.params]
        self.lr_w_base, self.lr_f_base = schedules.scaled_base_lrs(conf)
        self.cdfs = None
        if conf.renderer.fixed_graph_seeds:
            self.cdfs = self._shard_cdfs(None)
        self.ckpt_dir = os.path.join(f"{conf.monitor_base_path}_multiscene",
                                     "checkpoints")
        self.start_epoch = 0
        self.history = []  # per step: one {monitor: value} per local scene
        self._maybe_resume()
        if not plan.is_trivial:  # a row starts from its first rank's state
            src = plan.data_index * plan.shape[1]
            group = plan.row_reducer.group
            for p, o in zip(self.params, self.opt_states):
                for t in (p, o["mu"], o["nu"]):
                    plan.broadcast(t, src, group)
        self._make_monitors()

    def _shard_cdfs(self, step):
        conf = self.conf
        return self.plan.shard_cdfs(make_mc_cdfs(
            conf, conf.train.batch_size, conf.train.n_rays, step=step,
            device=self.device), data=False)

    # -- checkpoints ---------------------------------------------------------
    def _owner(self, i: int) -> int:
        """The rank that sends scene ``i``'s state to rank 0: its row's
        first."""
        return i // len(self.local) * self.plan.shape[1]

    def _tree(self, j: int, name: str):
        """Local scene ``j``'s parameters (``"params"``) or moments."""
        return self.params[j] if name == "params" \
            else self.opt_states[j][name]

    def _stacked_state(self):
        """(params, opt_state) of every scene stacked (S, ...) on rank 0's
        CPU, each row's first rank sending its scenes (collective; other
        ranks return (None, None))."""
        S, plan = len(self.scene_paths), self.plan
        names = ("params", "mu", "nu")
        out = {n: _stack_like(self._tree(0, n), S) for n in names} \
            if plan.is_main else None
        counts = [0] * S
        for i in range(S):
            owner = self._owner(i)
            if plan.rank not in (0, owner):
                continue
            j = i - self.local[0]
            if plan.rank == owner:
                for n in names:
                    dst = dict(tree_leaves_with_path(out[n])) \
                        if plan.is_main else None
                    for path, t in tree_leaves_with_path(self._tree(j, n)):
                        if dst is not None:
                            dst[path][i].copy_(t.detach().cpu())
                        else:
                            dist.send(t.detach().contiguous(), 0)
                counts[i] = self.opt_states[j]["count"]
                if not plan.is_main:
                    dist.send(torch.tensor([counts[i]], device=self.device),
                              0)
                continue
            for n in names:  # rank 0, another row's scene
                for _, d in tree_leaves_with_path(out[n]):
                    buf = torch.empty(d.shape[1:], dtype=d.dtype,
                                      device=self.device)
                    dist.recv(buf, owner)
                    d[i].copy_(buf.cpu())
            c = torch.zeros(1, dtype=torch.int64, device=self.device)
            dist.recv(c, owner)
            counts[i] = int(c.item())
        if not plan.is_main:
            return None, None
        return out["params"], {"count": counts, "mu": out["mu"],
                               "nu": out["nu"]}

    def save(self, epoch: int) -> None:
        """The stacked checkpoint of ``epoch`` (collective: every rank
        calls it; rank 0 writes)."""
        params_s, opt_s = self._stacked_state()
        if self.plan.is_main:
            save_checkpoint(self.ckpt_dir, epoch, params_s, opt_s,
                            extra={"scenes": self.scene_paths},
                            keep=self.conf.train.keep_checkpoints)
        if not self.plan.is_trivial:
            dist.barrier()

    def _maybe_resume(self):
        latest = latest_checkpoint(self.ckpt_dir)
        if not latest:
            return
        S = len(self.scene_paths)
        params_s = _stack_like(self.params[0], S)
        opt_s = {"count": 0, "mu": _stack_like(self.opt_states[0]["mu"], S),
                 "nu": _stack_like(self.opt_states[0]["nu"], S)}
        params_s, opt_s, extra = load_checkpoint(latest, params_s, opt_s)
        # same count, other scenes: a relaunch would train each scene's
        # parameters on another scene's images
        saved = extra.get("scenes")
        if saved is not None and list(saved) != self.scene_paths:
            raise ValueError(
                f"checkpoint {latest} was trained on scenes {saved}, but "
                f"this run lists {self.scene_paths}; refusing to resume "
                "(move monitor_base_path or match the scene list)")
        counts = opt_s["count"]
        if not isinstance(counts, list):
            counts = [counts] * S
        stored = dict(tree_leaves_with_path(params_s))
        mu = dict(tree_leaves_with_path(opt_s["mu"]))
        nu = dict(tree_leaves_with_path(opt_s["nu"]))
        with torch.no_grad():
            for j, i in enumerate(self.local):
                for tree, src in ((self.params[j], stored),
                                  (self.opt_states[j]["mu"], mu),
                                  (self.opt_states[j]["nu"], nu)):
                    for path, t in tree_leaves_with_path(tree):
                        t.copy_(src[path][i])
                self.opt_states[j]["count"] = int(counts[i])
        self.start_epoch = int(extra.get("step", 0)) + 1
        logger.info(f"[multi-scene] resumed from {latest} at epoch "
                    f"{self.start_epoch}")

    # -- monitors and validation --------------------------------------------
    def _make_monitors(self):
        self.series, self.monitor_time = {}, {}
        self.monitor_psnr, self.monitor_image = {}, {}
        if not self.writes:
            return
        for i in self.local:
            m = Monitor(self.monitor_paths[i])
            self.series[i] = {k: MonitorSeries(n, m, verbose=False)
                              for k, n in Trainer._SERIES.items()}
            self.monitor_time[i] = MonitorTimeElapsed("Training time", m)
            ds = self.datasets[i]
            Wl = ds.W // 2 ** self.conf.valid.n_down_samples
            Hl = ds.H // 2 ** self.conf.valid.n_down_samples
            self.monitor_psnr[i] = MonitorSeries(f"PSNR {Wl}x{Hl}", m)
            self.monitor_image[i] = MonitorImage(
                f"Rendered image {Wl}x{Hl}", m)

    def validate(self, epoch: int, final: bool = False):
        """Render + PSNR + meshes of each of this row's scenes (the
        single-scene validation over :meth:`scene_params`)."""
        if not self.writes:
            return
        for i in self.local:
            validate_scene(self.scene_params(i), self.scene_confs[i],
                           self.datasets[i], self.monitor_paths[i],
                           self.monitor_psnr[i], self.monitor_image[i],
                           epoch, final, chamfer=False)

    def scene_params(self, i: int):
        """Scene ``i``'s parameter tree (on a rank of its row)."""
        if i not in self.local:
            raise ValueError(f"scene {i} is trained by another row of the "
                             f"mesh, not by rank {self.plan.rank}")
        return self.params[i - self.local[0]]

    # -- training -------------------------------------------------------------
    def next_batch(self):
        """One batch of every scene, drawn from every dataset (so each
        rank's data order is the same); this rank's scenes and rays, as
        lists of (B, 3) and (B, R, .) tensors."""
        B = self.conf.train.batch_size
        out = [[], [], [], []]
        for i, ds in enumerate(self.datasets):
            color, mask, intrinsic, pose, xy = ds.next_batch(B)
            if i not in self.local:
                continue
            raydir, camloc = generate_raydir_camloc(pose, intrinsic, xy)
            for k, (a, rays) in enumerate(((camloc, False), (raydir, True),
                                           (color, True), (mask, True))):
                t = torch.from_numpy(a).to(self.device)
                out[k].append(self.plan.shard(t, data=False, rays=rays))
        return out

    def train(self, epochs: Optional[int] = None):
        """Train epochs [start_epoch, epochs) (the config's schedule by
        default); returns the per-step history of this rank's scenes."""
        conf = self.conf
        E = epochs if epochs is not None else conf.train.epoch
        iters = min(ds.iters_per_epoch for ds in self.datasets)
        every = conf.train.checkpoint_interval_epochs
        reducer = self.plan.row_reducer
        for epoch in range(self.start_epoch, E):
            if (epoch != 0 and conf.valid.epoch_interval > 0
                    and epoch % conf.valid.epoch_interval == 0
                    and not conf.valid.skip):
                self.validate(epoch)
            lr_w, lr_f, car, lvg = epoch_schedule(epoch, self.lr_w_base,
                                                  self.lr_f_base, conf)
            epoch_mons = []
            for it in range(iters):
                gstep = epoch * iters + it
                cdfs = self.cdfs if self.cdfs is not None \
                    else self._shard_cdfs(gstep)
                epoch_mons.append(multi_scene_train_step(
                    self.params, self.opt_states, *self.next_batch(), car,
                    lvg, lr_w, lr_f, gstep, conf, cdfs=cdfs,
                    reducer=reducer))
            for it, mons in enumerate(epoch_mons):
                mons = [{k: v.item() for k, v in m.items()} for m in mons]
                self.history.append(mons)
                if not self.writes:
                    continue
                gstep = epoch * iters + it
                for i, m in zip(self.local, mons):
                    for k, s in self.series[i].items():
                        s.add(gstep, m[k])
                    if not m["grads_finite"]:
                        logger.info(f"[multi-scene] non-finite grads for "
                                    f"scene {i} at epoch {epoch} iter {it} "
                                    "(update skipped)")
            if self.writes:
                losses = np.mean([[m["loss"] for m in mons]
                                  for mons in self.history[-iters:]], axis=0)
                logger.info(f"[multi-scene] epoch {epoch}: losses {losses}")
                for i in self.local:
                    self.monitor_time[i].add(epoch)
            if every > 0 and (epoch + 1) % every == 0:
                self.save(epoch)
        if E > self.start_epoch:
            self.save(E - 1)
        self.start_epoch = max(self.start_epoch, E)
        if not conf.valid.skip:
            self.validate(E - 1, final=True)
        return self.history
