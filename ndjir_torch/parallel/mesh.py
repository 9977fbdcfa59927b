"""Ray-sharded data parallelism over ``torch.distributed`` (counterpart of
the JAX package's ``parallel/mesh.py``).

``parallel.mesh_shape = [data, rays]`` lays the world's ranks out row by
row: rank ``d * rays + r`` takes slice ``d`` of the image batch B and slice
``r`` of the ray axis R of every (B, R, ...) array.  A row of ranks (one
``d``) is a scene group of the multi-scene trainer.  One process drives one
device; NCCL on the card, gloo on the CPU.

The loss is not a mean of per-shard means: every term divides a sum over
rays by a count over the whole batch (``render/loss.py``).  So a sharded
step (1) sums the counts across its shards before the division
(:meth:`ShardReducer.counts`), which makes each shard's loss its share of
the batch's loss, then (2) sums the shards' gradients
(:meth:`ShardReducer.grads`); weight decay, clipping and the finite check
act once on that sum, in the optimizer.  ``DistributedDataParallel`` would
average the per-rank gradients instead, a different step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


class ShardReducer:
    """The collectives of one sharded step, over the ranks of ``group``
    (``None``: every rank).  They read nothing back to the host, so a CUDA
    graph capture of the step holds them (``train.graph.CapturedStep``)."""

    def __init__(self, group=None):
        self.group = group

    def counts(self, t: torch.Tensor) -> torch.Tensor:
        """The loss's denominators, summed over the group."""
        t = t.detach().clone()
        dist.all_reduce(t, group=self.group)
        return t

    def grads(self, grads: Dict) -> Dict:
        """Every gradient leaf summed over the group, in place."""
        for v in grads.values():
            if isinstance(v, dict):
                self.grads(v)
            else:
                dist.all_reduce(v, group=self.group)
        return grads

    def monitors(self, mons: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """The loss terms summed over the group (each shard holds its share
        of every term); ``gain`` is a parameter's and stays."""
        keys = [k for k in mons if k != "gain"]
        t = torch.stack([mons[k].float() for k in keys])
        dist.all_reduce(t, group=self.group)
        return dict(mons, **{k: v for k, v in zip(keys, t.unbind())})


class ShardingPlan:
    """Where this rank sits on the ``[data, rays]`` mesh and which slice of
    a batch it takes.  ``is_trivial`` (mesh ``[1, 1]``): no process group,
    no collectives, every slice the whole."""

    def __init__(self, conf):
        shape = tuple(int(n) for n in conf.parallel.mesh_shape)
        if len(shape) != 2 or min(shape) < 1:
            raise ValueError(f"parallel.mesh_shape {list(shape)} is not "
                             "[data, rays] with both >= 1")
        self.shape = shape
        n = shape[0] * shape[1]
        self.is_trivial = n == 1
        self.rank, self.world_size = 0, 1
        self.reducer = self.row_reducer = None
        if not self.is_trivial:
            if not dist.is_initialized():
                raise ValueError(
                    f"mesh_shape {list(shape)} needs {n} processes under "
                    "torch.distributed; call parallel.multi_scene."
                    "initialize_distributed first")
            self.rank, self.world_size = dist.get_rank(), \
                dist.get_world_size()
            if self.world_size != n:
                raise ValueError(f"mesh_shape {list(shape)} needs {n} "
                                 f"processes, have {self.world_size}")
            # every rank creates every row's group, in the same order
            rows = [dist.new_group(list(range(d * shape[1],
                                              (d + 1) * shape[1])))
                    for d in range(shape[0])]
            self.reducer = ShardReducer(None)
            self.row_reducer = ShardReducer(rows[self.rank // shape[1]])
        self.data_index, self.ray_index = divmod(self.rank, shape[1])
        self.is_main = self.rank == 0

    def _take(self, x: torch.Tensor, dim: int, axis: int) -> torch.Tensor:
        parts = self.shape[axis]
        if parts == 1:
            return x
        n = x.shape[dim]
        if n % parts:
            raise ValueError(f"axis {dim} of a {tuple(x.shape)} array does "
                             f"not split into {parts} shards")
        i = self.data_index if axis == 0 else self.ray_index
        return x.narrow(dim, i * (n // parts), n // parts).contiguous()

    def shard(self, x: torch.Tensor, data: bool = True,
              rays: bool = True, lead: int = 0) -> torch.Tensor:
        """This rank's slice of ``x``: after its first ``lead`` axes, kept
        whole, the next axis, B, over the data axis (when ``data``), and
        the one after, R, over the rays axis (when ``rays``)."""
        if data:
            x = self._take(x, lead, 0)
        if rays:
            x = self._take(x, lead + 1, 1)
        return x

    def shard_batch(self, camloc, raydir, color_gt, obj_mask
                    ) -> Tuple[torch.Tensor, ...]:
        """camloc (B, 3) over data; the (B, R, .) arrays over both."""
        return (self.shard(camloc, rays=False), self.shard(raydir),
                self.shard(color_gt), self.shard(obj_mask))

    def shard_batch_steps(self, camloc, raydir, color_gt, obj_mask
                          ) -> Tuple[torch.Tensor, ...]:
        """The K staged batches of one ``train_steps`` call (the JAX
        package's ``shard_batch_steps``): the steps axis K kept whole,
        camloc (K, B, 3) over data, the (K, B, R, .) arrays over both."""
        return (self.shard(camloc, rays=False, lead=1),
                self.shard(raydir, lead=1), self.shard(color_gt, lead=1),
                self.shard(obj_mask, lead=1))

    def shard_cdfs(self, cdfs: Dict, data: bool = True) -> Dict:
        """The Monte-Carlo uniforms of the whole batch, (B, R, ...) each,
        cut like the rays they go with."""
        return {k: [self.shard(u, data=data) for u in v]
                if isinstance(v, list) else self.shard(v, data=data)
                for k, v in cdfs.items()}

    def broadcast(self, tree: Dict, src: int = 0,
                  group: Optional[object] = None) -> Dict:
        """Every tensor leaf of ``tree`` overwritten, in place, with rank
        ``src``'s."""
        for v in tree.values():
            if isinstance(v, dict):
                self.broadcast(v, src, group)
            elif isinstance(v, torch.Tensor):
                dist.broadcast(v, src, group=group)
        return tree
