"""Epoch schedules: LR warmup+cosine, NeuS cos-anneal, photogrammetric gain.

Pure functions of the epoch index (reference: python/solver.py:82-119); the
port's copy of ``ndjir_tpu/train/schedules.py``.  The trainer passes their
values into each step as plain floats.
"""

from __future__ import annotations

import numpy as np


def learning_rate(epoch: int, base_lr: float, conf) -> float:
    """Linear warmup then cosine decay to ``end_ratio * base_lr``
    (reference: solver.py:82-98)."""
    E = conf.train.epoch
    warmup = int(E * conf.train.warmup_term_ratio)
    warmup = 0 if warmup < 1 else warmup
    end_ratio = conf.train.learning_rate_end_ratio
    if warmup > 0 and epoch < warmup:
        return base_lr * epoch / warmup
    x = np.pi * (epoch - warmup) / (E - warmup)
    a = (1 - end_ratio) * base_lr / (1 + np.cos(np.pi * warmup / E))
    b = a + end_ratio * base_lr
    return float(np.cos(x) * a + b)


def scaled_base_lrs(conf):
    """LRs linearly scaled by (B*R)/512 (reference: solver.py:24-27)."""
    B, R = conf.train.batch_size, conf.train.n_rays
    s = (B * R) / (1 * 512)
    return (conf.train.base_learning_rate_weight * s,
            conf.train.base_learning_rate_feat * s)


def cos_anneal_ratio(epoch: int, conf) -> float:
    """Half-cosine 0 -> 1 over cos_anneal_term_ratio of training
    (reference: solver.py:100-108)."""
    end_epoch = conf.train.epoch * conf.train.cos_anneal_term_ratio
    x = epoch / end_epoch
    return float(0.5 * np.cos(np.pi * x) + 0.5) if x < 1.0 else 1.0


def light_visibility_gain(epoch: int, conf) -> float:
    """Cosine 1 -> sigmoid_gain_lv_end over training
    (reference: solver.py:110-119)."""
    M = conf.train.sigmoid_gain_lv_end
    b = (M + 1) * 0.5
    a = 1 - b
    return float(a * np.cos(np.pi * epoch / conf.train.epoch) + b)
