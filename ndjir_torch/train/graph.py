"""One training step captured as a CUDA graph and replayed (the port's
counterpart of the JAX package's one-program steps: the ``train_steps``
scan, ``ndjir_tpu/train/trainer.py:62-95``, sharded or not, and the
multi-scene step, ``ndjir_tpu/parallel/multi_scene.py:67-90``).

:class:`CapturedStep` records one whole ``train_step`` (sampler ->
``pb_render`` -> loss -> the eikonal double backward -> dual Adam, its
scatter and fold kernels included) into a ``torch.cuda.CUDAGraph`` and
replays it once per step.  One graph may hold the steps of several
(parameters, optimizer state) pairs one after another, the S scenes of the
multi-scene trainer; the caching allocator hands a later scene's
transients the blocks an earlier one freed, inside the graph's pool.  A
sharded step's collectives (``parallel.mesh.ShardReducer``: the loss's
counts, the gradients, the monitors, the finite flag) are captured with
it, over NCCL.  The graph reads its inputs from static buffers that it
owns (each scene's batch, the Monte-Carlo uniforms, the coarse-grid
snapshot and the four schedule scalars) and updates the parameters and the
optimizer states in place, at the addresses it was captured with.  Before
each replay the step's batches are copied into the buffers on the same
stream, so a call of K steps never waits on the host.

The first call, and any call after a parameter, moment or count tensor was
replaced, a shape changed or the process group did, runs one eager step
on a side stream (the warm-up, which is the call's first step), frees the
warm-up's cached memory and captures.  A failed capture raises; there is no
fallback to the eager loop.  Kernel wrappers count a launch where they
launch (``kernels.LAUNCHES``), which a replay does not pass through: the
launches the capture recorded are added to the counts at every replay
instead, so the counts stay exact.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ndjir_torch import kernels
from ndjir_torch.train.optim import tree_leaves_with_path
from ndjir_torch.utils.profiling import annotate


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
    """One ``step_fn`` (``train_step``'s signature) over a list of
    (params, opt_state) pairs, captured on the card for a model ``conf``;
    see the module docstring.  :meth:`run` trains K steps and returns each
    pair's monitors stacked along K."""

    def __init__(self, step_fn: Callable, conf):
        self.step_fn = step_fn
        self.conf = conf
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.key = None
        self.reducer = None
        self.captures = 0
        self.replays = 0
        # kernel launches recorded in the graph, added at each replay
        self.tally: Dict[str, int] = {}

    @staticmethod
    def _key(states, batch0, cdfs, per_step_cdfs, proposal_grid, reducer):
        state = []
        for params, opt_state in states:
            state += [t for _, t in tree_leaves_with_path(params)] \
                + [t for _, t in tree_leaves_with_path(opt_state["mu"])] \
                + [t for _, t in tree_leaves_with_path(opt_state["nu"])] \
                + [opt_state["count"]]
        # the process group the collectives were captured on (None: no
        # collectives); the default group is looked up, so a new one after
        # destroy_process_group is another key
        group = None if reducer is None else (
            reducer.group if reducer.group is not None else dist.group.WORLD,)
        return (tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                      for t in state),
                tuple(tuple(_shapes(b) for b in scene) for scene in batch0),
                _shapes(cdfs), per_step_cdfs, _shapes(proposal_grid), group)

    def release(self) -> None:
        """Drop the graph and its buffers (its memory pool with them)."""
        self.graph = self.key = self.reducer = None
        self.batch = self.cdfs = self.grid = self.sched = None
        self.mon_vec = None

    def _step(self, states):
        s = self.sched
        vecs = []
        for (params, opt_state), batch in zip(states, self.batch):
            mons = self.step_fn(params, opt_state, *batch, s[0], s[1], s[2],
                                s[3], self.conf, cdfs=self.cdfs, step=None,
                                proposal_grid=self.grid,
                                reducer=self.reducer)
            self.names = list(mons)
            vecs.append(torch.stack([mons[k].float() for k in self.names]))
        return torch.stack(vecs)

    def _warm_up_and_capture(self, states) -> torch.Tensor:
        """The call's first step, eager on a side stream, then the
        capture (which runs nothing).  Returns the first step's monitors.
        With collectives the capture is thread-local: ProcessGroupNCCL's
        watchdog thread queries the events of the warm-up's collectives
        meanwhile, which a global capture forbids."""
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = self._step(states)
        cur.wait_stream(side)
        first.record_stream(cur)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        mode = "global" if self.reducer is None else "thread_local"
        before = dict(kernels.LAUNCHES)
        try:
            with torch.cuda.graph(graph, capture_error_mode=mode):
                self.mon_vec = self._step(states)
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

    def run(self, states: Sequence, batches: Sequence, sched: Sequence,
            cdfs, proposal_grid=None,
            step_cdfs: Optional[Callable[[int], Dict]] = None,
            reducer=None) -> List[Dict[str, torch.Tensor]]:
        """K steps of every (params, opt_state) pair of ``states``, pair s
        on the staged batch arrays ``batches[s]`` = (camloc, raydir,
        color_gt, obj_mask), each with a leading K axis.  ``sched`` holds
        (cos_anneal, lv_gain, lr_weight, lr_feat); ``cdfs`` the uniforms
        shared by every step and pair, or None with ``step_cdfs(j)``
        drawing step j's (outside the graph; copied in like the batch);
        ``reducer`` the sharded step's collectives (a
        ``parallel.mesh.ShardReducer``) or None.  Returns, per pair, its
        monitors stacked along K."""
        K = batches[0][0].shape[0]
        device = batches[0][0].device
        per_step = cdfs is None
        first_cdfs = step_cdfs(0) if per_step else cdfs
        batch0 = [tuple(b[0] for b in scene) for scene in batches]
        key = self._key(states, batch0, first_cdfs, per_step, proposal_grid,
                        reducer)
        if key != self.key:
            self.release()
            self.key = key
            self.reducer = reducer
            self.batch = [[_like(b) for b in scene] for scene in batch0]
            self.cdfs = _like(first_cdfs)
            self.grid = None if proposal_grid is None \
                else _like(proposal_grid)
            self.sched = torch.empty(4, dtype=torch.float32, device=device)
        self.sched.copy_(torch.stack(device_scalars(sched, device)))
        if proposal_grid is not None:
            self.grid.copy_(proposal_grid)
        _copy(self.cdfs, first_cdfs)
        mons = None
        for j in range(K):
            for buf, scene in zip(self.batch, batches):
                _copy(buf, [b[j] for b in scene])
            if per_step and j > 0:
                _copy(self.cdfs, step_cdfs(j))
            if self.graph is None:
                with annotate("graph.capture"):
                    vec = self._warm_up_and_capture(states)
            else:
                self.graph.replay()
                self.replays += 1
                for k, n in self.tally.items():
                    kernels.count(k, n)
                vec = self.mon_vec
            if mons is None:
                mons = torch.empty((K, *vec.shape), dtype=vec.dtype,
                                   device=vec.device)
            mons[j].copy_(vec)
        out = []
        for s in range(len(states)):
            m = {k: mons[:, s, i] for i, k in enumerate(self.names)}
            m["grads_finite"] = m["grads_finite"] > 0.5
            out.append(m)
        return out
