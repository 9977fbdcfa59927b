"""Training driver: ``Trainer.train`` of ``ndjir_torch`` on a scene made from
the seed, one epoch per call, as ``python -m ndjir_torch.cli train`` runs
it.

Set-up makes the scene on the card (``benchmark.scene``), builds the
port's dataset and ``Trainer`` from the configuration as run, hands the
trainer the weights the benchmark draws from the seed
(``benchmark.reference``'s initialization, the published laws), and
trains the first epoch through the window's own call: that epoch is the
warm-up (kernels built, the step captured where ``steps_per_call`` > 1)
and the one the comparison follows.  Training starts at the traffic's
``start_epoch``, the first whose learning rate is above 0 (the schedule
warms up from 0 and lags one epoch), so that the epoch moves the weights.

The window trains whole epochs until ``--seconds`` have passed; each ends
in the trainer's one fetch of the epoch's monitors, so the clock reads
finished work.  ``train_rays_per_s`` is ``B R`` times the steps over the
window's wall time.

The comparison (:mod:`benchmark.compare`) follows the checked epoch with
the plain reference from the same weights, scene and draws: each step's
loss, the norm of each leaf's first moment (the gradients as the
optimizer got them) and of each leaf's change.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List

import numpy as np

from benchmark import compare
from benchmark import scene as scene_mod
from benchmark.reference.follow import leaf_norms
from benchmark.reference.train.optim import tree_leaves_with_path


def run_conf(cell, ctx_scratch: str) -> Dict:
    """The configuration as run, plus the run's paths and the traffic's
    call grouping."""
    data = copy.deepcopy(cell.config["config"])
    data["train"]["steps_per_call"] = int(cell.traffic["steps_per_call"])
    data["data_path"] = f"bench/{cell.traffic_name}"
    data["monitor_base_path"] = f"{ctx_scratch}/monitor"
    return data


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cell = ctx.cell
        self.traffic = self.cell.traffic
        self.restore: List = []

    def setup(self) -> None:
        from ndjir_torch.config import Config
        from ndjir_torch.data.dataset import IDRDataset
        from ndjir_torch.train import trainer as trainer_mod
        from ndjir_torch.train.trainer import Trainer
        from benchmark.reference import weights

        ctx = self.ctx
        dev = ctx.device
        self.scene = scene_mod.make_scene(self.traffic["scene"],
                                          ctx.seeds["scene"], dev)
        self.data = run_conf(self.cell, ctx.scratch)
        conf = Config(self.data)
        ds = IDRDataset(conf, *self.scene, train=True, shuffle=True,
                        rng=np.random.RandomState(ctx.seeds["data"]))
        self.trainer = tr = Trainer(conf, dataset=ds, device=dev,
                                    seed=ctx.seeds["weights"])
        weights.load_into(tr.params, weights.draw(self.cell.config["config"],
                                                   ctx.seeds["weights"], dev))
        if ctx.trace:
            self._instrument(trainer_mod)
        tr.start_epoch = int(self.traffic["start_epoch"])
        self.iters = ds.iters_per_epoch
        tr.train(stop_epoch=tr.start_epoch + 1)
        hist = tr.history[-self.iters:]
        self.checked = {
            "losses": [h["loss"] for h in hist],
            "finite": all(h["grads_finite"] for h in hist),
            "moments": leaf_norms(tr.opt_state["mu"]),
            "params": {"/".join(path): t.detach().to("cpu", copy=True)
                       for path, t in tree_leaves_with_path(tr.params)},
        }

    def _instrument(self, trainer_mod) -> None:
        """Host spans around the batch feed and the monitors' fetch, and
        the shapes of the scatter kernel's launches (B1), which the traced
        run's readers take."""
        from ndjir_torch.ops import scatter

        ctx, tr = self.ctx, self.trainer
        tr.next_batch = ctx.span("host_batch", tr.next_batch)
        tr.next_batches = ctx.span("host_batch", tr.next_batches)
        self.scatter_shapes: List = []
        real = scatter._scatter_add_rows_cuda

        def recorded(ids, vals, num_rows, transposed):
            self.scatter_shapes.append(
                (ids.numel(), vals.shape[-1], num_rows, ids.element_size(),
                 vals.element_size()))
            return real(ids, vals, num_rows, transposed)
        self.restore = [(trainer_mod, "fetch_monitors",
                         trainer_mod.fetch_monitors),
                        (scatter, "_scatter_add_rows_cuda", real)]
        trainer_mod.fetch_monitors = ctx.span("fetch_monitors",
                                              trainer_mod.fetch_monitors)
        scatter._scatter_add_rows_cuda = recorded

    def window(self, seconds: float) -> Dict:
        from ndjir_torch import kernels

        tr = self.trainer
        before = dict(kernels.LAUNCHES)
        n0 = len(tr.history)
        t0 = time.perf_counter()
        while True:
            tr.train(stop_epoch=tr.start_epoch + 1)
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        hist = tr.history[n0:]
        steps = len(hist)
        rays = steps * self.data["train"]["batch_size"] \
            * self.data["train"]["n_rays"]
        failed = sum(1 for h in hist if not (h["grads_finite"]
                                             and np.isfinite(h["loss"])))
        out = {"kind": "train", "attempted": steps, "failed": failed,
               "rays": rays, "conf": self.data,
               "metrics": {"train_rays_per_s": rays / wall}}
        if self.ctx.trace:
            launches = kernels.LAUNCHES["scatter_add_rows"] \
                - before["scatter_add_rows"]
            per_step = launches // max(steps, 1)
            out["scatter_launches"] = launches
            out["scatter_shapes"] = self.scatter_shapes[:per_step]
        return out

    def release(self) -> None:
        for mod, name, fn in self.restore:
            setattr(mod, name, fn)
        self.trainer.graph.release()
        del self.trainer

    def check(self, limits: Dict) -> List[Dict]:
        """The comparison of the checked epoch with the plain reference."""
        from benchmark.reference import follow

        ref = follow.train_epoch(self.cell.config["config"], self.scene,
                                 self.ctx.seeds, self.traffic,
                                 self.iters, self.ctx.device)
        return compare.train_checks(self.checked, ref, limits,
                                    self.ctx.device)
