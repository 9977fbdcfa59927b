"""The numbers that decide ``correct``: what the timed path produced
against what the plain reference computes from the same inputs, each with
its limit (``benchmark/checks/<cell>.json``, which gives the readings the
limit was set from).

Training (the checked epoch, set-up's first through the window's call):

- ``first_loss_gap`` and ``loss_gap``: the relative gap ``|L - L_ref| /
  |L_ref|`` of the first step's loss, and the largest over every step;
- ``moment_gap_median`` and ``moment_gap``: each leaf's gap between the
  norms of the program's and the reference's first moment after the
  epoch (the gradients as the optimizer got them), against the
  reference's norm of that leaf or of the median leaf, whichever is
  larger; the median over the leaves, and the worst leaf;
- ``change_gap_median`` and ``change_gap``: the same of each leaf's change
  from the initial weights, over the leaves whose reference first moment
  is at least a thousandth of the median leaf's (a leaf whose gradient is
  nought to rounding moves by round-off alone under Adam).

A step that was not finite, on either side, makes every number infinite.
The reference's own ``index_add_`` sums in an order that changes from run
to run, and over an epoch of Adam steps that rounding moves the later
losses, the worst leaves and the moments of two reference runs apart as
far as the program's: the limits of those numbers lie above that noise
and below the control or the half-batch fault (PERF.md gives both).

Rendering (a view sampled from those the window rendered): ``color_gap``
and ``normal_gap``, the largest absolute gap of the view's colour and
normal maps.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

# leaves whose reference moment is below this share of the median leaf's
# are left out of the change
NOUGHT = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[set] = None) -> Dict[str, float]:
    """Each leaf's gap of norms against max(the reference's norm of that
    leaf, of the median leaf)."""
    med = statistics.median(ref.values())
    out = {}
    for n in ref:
        scale = max(ref[n], med)
        if (keep is None or n in keep) and scale > 0.0:
            out[n] = abs(prog[n] - ref[n]) / scale
    return out


def loss_gap(prog: List[float], ref: List[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def _moved(ref: Dict) -> set:
    med = statistics.median(ref["moments"].values())
    return {n for n, v in ref["moments"].items() if v >= NOUGHT * med}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared, from the program's readings (``losses``,
    ``finite``, ``moments``, ``changes``) and the reference's."""
    names = ("first_loss_gap", "loss_gap", "moment_gap_median",
             "moment_gap", "change_gap_median", "change_gap")
    if not (prog["finite"] and ref["finite"]):
        return dict.fromkeys(names, math.inf)
    moved = _moved(ref)
    moments = leaf_gaps(prog["moments"], ref["moments"])
    changes = leaf_gaps(prog["changes"], ref["changes"], moved)
    return dict(zip(names, (
        loss_gap(prog["losses"][:1], ref["losses"][:1]),
        loss_gap(prog["losses"], ref["losses"]),
        statistics.median(moments.values()), max(moments.values()),
        statistics.median(changes.values()), max(changes.values()))))


def _entry(name: str, value: float, limits: Dict) -> Dict:
    limit = limits.get(name)
    # a number that is not finite is printed as null and fails
    v = value if math.isfinite(value) else None
    return {"name": name, "value": v,
            "limit": None if limit is None else limit["limit"]}


def change_norms(params_host: Dict[str, torch.Tensor], p0: dict,
                 device) -> Dict[str, float]:
    """Each leaf's ``||p - p0||``, ``params_host`` on the host, one leaf at
    a time on ``device``."""
    from benchmark.reference.train.optim import tree_leaves_with_path

    p0_leaves = {"/".join(path): t for path, t in tree_leaves_with_path(p0)}
    return {n: float(torch.linalg.vector_norm(
        (t.to(device) - p0_leaves[n]).float()))
        for n, t in params_host.items()}


def train_checks(checked: Dict, ref: Dict, limits: Dict, device
                 ) -> List[Dict]:
    prog = dict(checked, changes=change_norms(checked["params"], ref["p0"],
                                              device))
    nums = train_numbers(prog, ref)
    return [_entry(n, v, limits) for n, v in nums.items()]


def render_numbers(prog, ref) -> Dict[str, float]:
    """``prog`` and ``ref``: (image, normal, mask) of one view."""
    def gap(a, b):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        return float(d.max()) if np.isfinite(d).all() else math.inf
    return {"color_gap": gap(prog[0], ref[0]),
            "normal_gap": gap(prog[1], ref[1])}


def render_checks(prog, ref, limits: Dict) -> List[Dict]:
    return [_entry(n, v, limits) for n, v in render_numbers(prog, ref).items()]
