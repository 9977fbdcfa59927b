"""IDR-format multi-view dataset with three ray-sampling modes.

The port's copy of ``ndjir_tpu/data/dataset.py`` (host-side numpy).  An IDR
scene folder holds ``image/*``, ``mask/*`` (binarized at >127.5) and
``cameras.npz`` (``world_mat_i`` / ``scale_mat_i``; P = W @ S decomposed to
K, pose).  :func:`load_idr_folder` reads one with the port's own PNG reader
(:mod:`ndjir_torch.utils.png`), and :meth:`IDRDataset.from_folder` builds
the dataset from it; the constructor takes the same contents as in-memory
arrays.  Ray batches are uniform random pixels, random 2^n x 2^m patches, or
stratified foreground/background by mask ratio, drawn exactly as the
reference draws them (parity with reference python/dataset.py:28-227).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Tuple

import numpy as np

from ndjir_torch.data.cameras import load_K_Rt_from_P
from ndjir_torch.utils.png import read_png


def load_idr_folder(path: str) -> Tuple[np.ndarray, np.ndarray,
                                        Dict[str, np.ndarray]]:
    """(images (n, H, W, C) uint8, masks (n, H, W[, C]) uint8, the
    ``cameras.npz`` entries) of the IDR folder at ``path``, the image and
    mask files each in sorted name order (reference: dataset.py:111-138)."""
    image_files = sorted(glob.glob(os.path.join(path, "image", "*")))
    if not image_files:
        raise FileNotFoundError(f"No images under {path}/image")
    images = np.asarray([read_png(f) for f in image_files])
    mask_files = sorted(glob.glob(os.path.join(path, "mask", "*")))
    masks = np.asarray([read_png(f) for f in mask_files])
    with np.load(os.path.join(path, "cameras.npz")) as cameras:
        return images, masks, dict(cameras)


class IDRDataset:
    def __init__(self, conf, images: np.ndarray, masks: np.ndarray,
                 cameras: Dict[str, np.ndarray], train: bool = True,
                 shuffle: bool = False,
                 rng: np.random.RandomState | None = None):
        """images (n, H, W, 3|4) uint8; masks (n, H, W[, C]) uint8;
        cameras: ``world_mat_i`` / ``scale_mat_i`` 4x4 arrays, i < n."""
        self.conf = conf
        self.n_rays = conf.train.n_rays
        self.train = train
        self._shuffle = shuffle

        self.images, self.masks, self.intrinsics, self.poses = \
            self._decode(images, masks, cameras)
        self.intrinsics_inv = np.linalg.inv(self.intrinsics)

        H, W, _ = self.images[0].shape
        self.H, self.W = H, W
        self.n_pixels = H * W
        xx, yy = np.meshgrid(np.arange(W), np.arange(H))
        self.xy = np.asarray([xx.flatten(), yy.flatten()]).T

        self.size = len(self.images)
        # the reference's seed for process 0; every rank of a sharded run
        # draws the same batches and takes its slice (parallel/mesh.py)
        self.rng = rng if rng is not None else np.random.RandomState(313)
        self.reset()

    @classmethod
    def from_folder(cls, conf, path: str | None = None, train: bool = True,
                    shuffle: bool = False) -> "IDRDataset":
        """The dataset of the IDR folder at ``path`` (default
        ``conf.data_path``)."""
        path = conf.data_path if path is None else path
        return cls(conf, *load_idr_folder(path), train=train, shuffle=shuffle)

    def _decode(self, images, masks, cameras):
        images = (np.asarray(images) / 255.0).astype(np.float32)
        if images.shape[-1] == 4:  # drop alpha if present
            images = images[..., :3]
        masks = np.asarray(masks)
        if masks.ndim == 4:
            masks = masks.mean(axis=-1)
        masks = (masks > 127.5)[..., np.newaxis] * 1.0

        world_mats = [cameras[f"world_mat_{i}"].astype(np.float32)
                      for i in range(len(images))]
        scale_mats = [cameras[f"scale_mat_{i}"].astype(np.float32)
                      for i in range(len(images))]
        intrinsics, poses = [], []
        for Wm, S in zip(world_mats, scale_mats):
            P = (Wm @ S)[:3, :4]
            intrinsic, pose = load_K_Rt_from_P(P)
            intrinsics.append(intrinsic[:3, :3])
            poses.append(pose)
        # scene de-normalization factors for Chamfer eval
        # (reference: dataset.py:136-137)
        self.scale = scale_mats[-1][0, 0]
        self.trans = scale_mats[-1][:3, 3]
        return images, masks, np.asarray(intrinsics), np.asarray(poses)

    # -- epoch state --------------------------------------------------------
    def reset(self):
        if self._shuffle:
            self._img_indices = self.rng.permutation(self.size)
        else:
            self._img_indices = np.arange(self.size)
        self._pixel_idx = self.rng.randint(
            0, self.n_pixels, (self.size, self.n_rays))
        self._pos = 0

    # -- ray sampling modes (reference: dataset.py:57-108) ------------------
    def _patch_rays(self, image, mask):
        H, W = self.H, self.W
        n = int(np.log2(self.n_rays))
        if self.rng.randint(0, 2):
            nH = n // 2
            nW = n - nH
        else:
            nW = n // 2
            nH = n - nW
        pH, pW = 2 ** nH, 2 ** nW
        if pH > H or pW > W:
            raise ValueError(
                f"patch {pH}x{pW} (from n_rays={self.n_rays}) exceeds the "
                f"{H}x{W} image")
        H0 = self.rng.randint(0, max(H - pH, 1))
        W0 = self.rng.randint(0, max(W - pW, 1))
        xy = np.asarray(np.meshgrid(np.arange(W0, W0 + pW),
                                    np.arange(H0, H0 + pH))).T.reshape(-1, 2)
        idx = xy[:, 1] * W + xy[:, 0]
        return image[idx], mask[idx], xy

    def _mask_rays(self, image, mask):
        ratio = self.conf.train.mask_ray_sample_ratio
        n_mask = int(ratio * self.n_rays)
        n_free = self.n_rays - n_mask
        midxs = np.where(mask.flatten() >= 0.5)[0]
        nidxs = np.where(mask.flatten() < 0.5)[0]
        # all-foreground / all-background views: fall back to the other set
        if len(midxs) == 0:
            midxs = nidxs
        if len(nidxs) == 0:
            nidxs = midxs
        midxs = midxs[self.rng.randint(0, len(midxs), n_mask)]
        nidxs = nidxs[self.rng.randint(0, len(nidxs), n_free)]
        idx = np.concatenate([midxs, nidxs])
        y = idx // self.W
        x = idx - y * self.W
        xy = np.stack([x, y], axis=-1)
        return image[idx], mask[idx], xy

    def get_item(self, position: int):
        img_idx = self._img_indices[position % self.size]
        image = self.images[img_idx].reshape(-1, 3)
        mask = self.masks[img_idx].reshape(-1, 1)
        if self.train and self.conf.train.patch_ray_sampling:
            color, m, xy = self._patch_rays(image, mask)
        elif self.train and self.conf.train.mask_ray_sample_ratio > 0:
            color, m, xy = self._mask_rays(image, mask)
        else:
            pidx = self._pixel_idx[img_idx]
            color, m, xy = image[pidx], mask[pidx], self.xy[pidx]
        return (color.astype(np.float32), m.astype(np.float32),
                self.intrinsics[img_idx].astype(np.float32),
                self.poses[img_idx].astype(np.float32),
                xy.astype(np.float32))

    def next_batch(self, batch_size: int):
        """(color (B,R,3), mask (B,R,1), intrinsic (B,3,3), pose (B,4,4),
        xy (B,R,2)); re-shuffles when an epoch of images is exhausted."""
        outs = []
        for _ in range(batch_size):
            if self._pos >= self.size:
                self.reset()
            outs.append(self.get_item(self._pos))
            self._pos += 1
        return tuple(np.stack(x) for x in zip(*outs))

    @property
    def iters_per_epoch(self) -> int:
        return max(1, self.size // self.conf.train.batch_size)
