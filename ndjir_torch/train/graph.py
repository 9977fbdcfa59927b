"""One training step captured as a CUDA graph and replayed (the port's
counterpart of the JAX package's ``train_steps`` scan,
``ndjir_tpu/train/trainer.py:62-95``).

:class:`CapturedStep` records one whole ``train_step`` (sampler ->
``pb_render`` -> loss -> the eikonal double backward -> dual Adam, its
scatter and fold kernels included) into a ``torch.cuda.CUDAGraph`` and
replays it once per step.  The graph reads its inputs from static buffers
that it owns (the batch, the Monte-Carlo uniforms, the coarse-grid snapshot
and the four schedule scalars) and updates the parameters and the optimizer
state in place, at the addresses it was captured with.  Before each replay
the step's batch is copied into the buffers on the same stream, so a call
of K steps never waits on the host.

The first call, and any call after the parameter tensors were replaced or a
shape changed, runs one eager step on a side stream (the warm-up, which is
the call's first step), frees the warm-up's cached memory and captures.  A
failed capture raises; there is no fallback to the eager loop.  Kernel
wrappers count a launch where they launch (``kernels.LAUNCHES``), which a
replay does not pass through: the launches the capture recorded are added
to the counts at every replay instead, so the counts stay exact.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ndjir_torch import kernels
from ndjir_torch.train.optim import tree_leaves_with_path


def device_scalars(values: Sequence, device) -> List[torch.Tensor]:
    """0-dim f32 tensors on ``device`` of ``values`` (floats or 0-dim
    tensors), made without waiting on the card: floats go over in one copy
    from pinned memory."""
    device = torch.device(device)
    if all(torch.is_tensor(v) for v in values):
        return [v.to(device=device, dtype=torch.float32) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float32)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return list(t.unbind())


def _like(x):
    """A new tensor (or list or dict of them) shaped like ``x``."""
    if isinstance(x, dict):
        return {k: _like(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_like(v) for v in x]
    return torch.empty_like(x)


def _copy(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy(dst[k], src[k])
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            _copy(d, s)
    else:
        dst.copy_(src)


def _shapes(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return tuple((k, _shapes(v)) for k, v in x.items())
    if isinstance(x, list):
        return tuple(_shapes(v) for v in x)
    return (tuple(x.shape), x.dtype)


class CapturedStep:
    """One ``step_fn`` (``train_step``'s signature) captured on the card
    for a model ``conf``; see the module docstring.  :meth:`run` trains K
    steps and returns their monitors stacked along K."""

    def __init__(self, step_fn: Callable, conf):
        self.step_fn = step_fn
        self.conf = conf
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.key = None
        self.captures = 0
        self.replays = 0
        # kernel launches recorded in the graph, added at each replay
        self.tally: Dict[str, int] = {}

    def _key(self, params, opt_state, batch, cdfs, per_step_cdfs,
             proposal_grid):
        state = [t for _, t in tree_leaves_with_path(params)] \
            + [t for _, t in tree_leaves_with_path(opt_state["mu"])] \
            + [t for _, t in tree_leaves_with_path(opt_state["nu"])] \
            + [opt_state["count"]]
        return (tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                      for t in state),
                tuple(_shapes(b) for b in batch), _shapes(cdfs),
                per_step_cdfs, _shapes(proposal_grid))

    def release(self) -> None:
        """Drop the graph and its buffers (its memory pool with them)."""
        self.graph = self.key = None
        self.batch = self.cdfs = self.grid = self.sched = None
        self.mon_vec = None

    def _step(self, params, opt_state):
        s = self.sched
        mons = self.step_fn(params, opt_state, *self.batch, s[0], s[1], s[2],
                            s[3], self.conf, cdfs=self.cdfs, step=None,
                            proposal_grid=self.grid)
        self.names = list(mons)
        return torch.stack([mons[k].float() for k in self.names])

    def _warm_up_and_capture(self, params, opt_state) -> torch.Tensor:
        """The call's first step, eager on a side stream, then the
        capture (which runs nothing).  Returns the first step's monitors."""
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = self._step(params, opt_state)
        cur.wait_stream(side)
        first.record_stream(cur)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        before = dict(kernels.LAUNCHES)
        try:
            with torch.cuda.graph(graph):
                self.mon_vec = self._step(params, opt_state)
        except BaseException:
            self.release()
            raise
        finally:
            self.tally = {k: n - before[k]
                          for k, n in kernels.LAUNCHES.items()}
            kernels.LAUNCHES.update(before)
        self.graph = graph
        self.captures += 1
        return first

    def run(self, params, opt_state, camloc, raydir, color_gt, obj_mask,
            sched: Sequence, cdfs, proposal_grid=None,
            step_cdfs: Optional[Callable[[int], Dict]] = None
            ) -> Dict[str, torch.Tensor]:
        """K steps on the staged (K, ...) batch arrays.  ``sched`` holds
        (cos_anneal, lv_gain, lr_weight, lr_feat); ``cdfs`` the uniforms
        shared by every step, or None with ``step_cdfs(j)`` drawing step
        j's (outside the graph; copied in like the batch)."""
        K = camloc.shape[0]
        per_step = cdfs is None
        first_cdfs = step_cdfs(0) if per_step else cdfs
        batch0 = (camloc[0], raydir[0], color_gt[0], obj_mask[0])
        key = self._key(params, opt_state, batch0, first_cdfs, per_step,
                        proposal_grid)
        if key != self.key:
            self.release()
            self.key = key
            self.batch = [_like(b) for b in batch0]
            self.cdfs = _like(first_cdfs)
            self.grid = None if proposal_grid is None \
                else _like(proposal_grid)
            self.sched = torch.empty(4, dtype=torch.float32,
                                     device=camloc.device)
        self.sched.copy_(torch.stack(device_scalars(sched, camloc.device)))
        if proposal_grid is not None:
            self.grid.copy_(proposal_grid)
        _copy(self.cdfs, first_cdfs)
        mons = None
        for j in range(K):
            _copy(self.batch, (camloc[j], raydir[j], color_gt[j],
                               obj_mask[j]))
            if per_step and j > 0:
                _copy(self.cdfs, step_cdfs(j))
            if self.graph is None:
                vec = self._warm_up_and_capture(params, opt_state)
            else:
                self.graph.replay()
                self.replays += 1
                for k, n in self.tally.items():
                    kernels.LAUNCHES[k] += n
                vec = self.mon_vec
            if mons is None:
                mons = torch.empty((K, vec.numel()), dtype=vec.dtype,
                                   device=vec.device)
            mons[j].copy_(vec)
        out = {k: mons[:, i] for i, k in enumerate(self.names)}
        out["grads_finite"] = out["grads_finite"] > 0.5
        return out
