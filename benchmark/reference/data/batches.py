"""The training batches of an IDR scene held in memory, drawn as the
reference's dataset draws them (uniform random pixels; python/dataset.py:
28-227): a frozen copy of the draw of ``ndjir_torch/data/dataset.py`` and
of the trainer's ray generation, for the benchmark's reference.  Only the
pixels drawn are decoded, each as the dataset decodes every pixel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from benchmark.reference.data.cameras import (
    generate_raydir_camloc,
    load_K_Rt_from_P,
)


class Batches:
    def __init__(self, images: np.ndarray, masks: np.ndarray,
                 cameras: Dict[str, np.ndarray], n_rays: int,
                 rng: np.random.RandomState, shuffle: bool = True):
        """images (n, H, W, 3) uint8; masks (n, H, W) uint8; cameras
        ``world_mat_i`` / ``scale_mat_i``; ``rng`` in the state the
        trainer's dataset starts from."""
        self.images, self.masks = images, masks
        self.size, self.H, self.W = images.shape[:3]
        self.n_rays, self.rng, self.shuffle = n_rays, rng, shuffle
        self.intrinsics, self.poses = [], []
        for i in range(self.size):
            P = (cameras[f"world_mat_{i}"].astype(np.float32)
                 @ cameras[f"scale_mat_{i}"].astype(np.float32))[:3, :4]
            intrinsic, pose = load_K_Rt_from_P(P)
            self.intrinsics.append(intrinsic[:3, :3])
            self.poses.append(pose)
        self.intrinsics = np.asarray(self.intrinsics)
        self.poses = np.asarray(self.poses)
        self._reset()

    def _reset(self):
        self.order = (self.rng.permutation(self.size) if self.shuffle
                      else np.arange(self.size))
        self.pixels = self.rng.randint(0, self.H * self.W,
                                       (self.size, self.n_rays))
        self.pos = 0

    def _item(self, position: int):
        i = self.order[position % self.size]
        p = self.pixels[i]
        y, x = p // self.W, p % self.W
        color = (self.images[i, y, x] / 255.0).astype(np.float32)
        m = self.masks[i, y, x]
        if m.ndim == 2:
            m = m.mean(axis=-1)
        mask = ((m > 127.5)[:, np.newaxis] * 1.0).astype(np.float32)
        xy = np.stack([x, y], axis=-1).astype(np.float32)
        return (color, mask, self.intrinsics[i].astype(np.float32),
                self.poses[i].astype(np.float32), xy)

    def next(self, batch_size: int) -> Tuple[np.ndarray, ...]:
        """(camloc (B, 3), raydir (B, R, 3), color (B, R, 3), mask
        (B, R, 1)), all float32."""
        items = []
        for _ in range(batch_size):
            if self.pos >= self.size:
                self._reset()
            items.append(self._item(self.pos))
            self.pos += 1
        color, mask, intrinsic, pose, xy = (np.stack(a) for a in zip(*items))
        raydir, camloc = generate_raydir_camloc(pose, intrinsic, xy)
        return camloc, raydir, color, mask
