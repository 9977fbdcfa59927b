"""Flat-file training monitors (nnabla Monitor-family equivalent).

The port's copy of ``ndjir_tpu/utils/monitor.py``: ``<name>.series.txt``
lines ``<index> <value>`` and ``<name>.timer.txt`` lines, in the same file
format, so existing plotting scripts keep working, and ``MonitorImage``'s
PNG dumps, written by the port's own PNG writer (:mod:`.png`).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from ndjir_torch.utils.png import write_png

logger = logging.getLogger("ndjir_torch")
if not logger.handlers:
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter("%(asctime)s [ndjir_torch] %(message)s"))
    logger.addHandler(h)
    logger.setLevel(logging.INFO)


class Monitor:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)


class MonitorSeries:
    def __init__(self, name: str, monitor: Monitor, interval: int = 1,
                 verbose: bool = True):
        self.name = name
        self.interval = interval
        self.verbose = verbose
        self.fpath = os.path.join(monitor.path,
                                  name.replace(" ", "-") + ".series.txt")

    def add(self, index: int, value):
        if index % self.interval != 0:
            return
        v = float(np.asarray(value))
        with open(self.fpath, "a") as f:
            f.write(f"{index} {v:.8g}\n")
        if self.verbose:
            logger.info(f"{self.name}={v:.6g} at {index}")


class MonitorTimeElapsed:
    def __init__(self, name: str, monitor: Monitor, interval: int = 1):
        self.name = name
        self.interval = interval
        self.fpath = os.path.join(monitor.path,
                                  name.replace(" ", "-") + ".timer.txt")
        self._start = time.time()
        self._last = self._start

    def add(self, index: int):
        if index % self.interval != 0:
            return
        now = time.time()
        with open(self.fpath, "a") as f:
            f.write(f"{index} {now - self._last:.4f} {now - self._start:.4f}\n")
        self._last = now


class MonitorImage:
    def __init__(self, name: str, monitor: Monitor, interval: int = 1):
        self.name = name
        self.interval = interval
        self.dir = os.path.join(monitor.path, name.replace(" ", "-"))
        os.makedirs(self.dir, exist_ok=True)

    def add(self, index: int, image: np.ndarray):
        """image: (1, C, H, W) or (H, W, C) float [0, 1]."""
        if index % self.interval != 0:
            return
        img = np.asarray(image)
        if img.ndim == 4:
            img = img[0].transpose(1, 2, 0)
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        write_png(os.path.join(self.dir, f"{index:06d}.png"), img)
