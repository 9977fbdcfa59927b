"""Rendered-image quality evaluation: PSNR (+mask, +Y), SSIM, LPIPS (the
port's copy of ``ndjir_tpu/eval/rendered.py``; images read with the port's
PNG reader).

Parity with reference scripts/evaluate_rendered_images.py:19-153 — metrics
are computed on 255-scale images, the masked variants weight by the binary
object mask, the Y-channel PSNR uses BT.601 luma, and an optional mean-match
"scale" mode aligns rendered/GT means under the mask before scoring.

LPIPS: the lpips package is not a dependency, so the VGG-based perceptual
distance is computed with torchvision's VGG16 features when torchvision and
its ImageNet weights are installed, and skipped (returned as None, logged)
otherwise.  The weights are read from torch's hub cache and never
downloaded.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from ndjir_torch.eval.image import ssim_map
from ndjir_torch.utils.monitor import Monitor, MonitorSeries, logger
from ndjir_torch.utils.png import read_png


def masked_psnr(pred: np.ndarray, gt: np.ndarray,
                mask: Optional[np.ndarray] = None,
                luma: bool = False) -> float:
    """pred/gt (H, W, 3) in [0, 255]; mask (H, W, 1) binary or None."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if luma:
        w = np.array([0.299, 0.587, 0.114])
        pred = (pred @ w)[..., None]
        gt = (gt @ w)[..., None]
    if mask is None:
        mask = np.ones_like(pred[..., :1])
    denom = mask.sum() * pred.shape[-1]
    mse = np.sum(((pred - gt) ** 2) * mask) / denom
    return float(10.0 * np.log10(255.0 ** 2 / mse))


def masked_ssim(pred: np.ndarray, gt: np.ndarray,
                mask: Optional[np.ndarray] = None) -> float:
    """SSIM map (eval.image.ssim_map) averaged under the mask, 255-scale."""
    smap = ssim_map(pred, gt, data_range=255.0, mode="same")
    if mask is None:
        return float(smap.mean())
    m = np.broadcast_to(mask, smap.shape)
    return float((smap * m).sum() / (m.sum() + 1e-12))


_LPIPS_NET = None


def lpips_vgg(pred: np.ndarray, gt: np.ndarray,
              mask: Optional[np.ndarray] = None) -> Optional[float]:
    """VGG16-feature perceptual distance in [-1,1] input convention; None if
    torchvision or its VGG16 ImageNet weights are not installed."""
    global _LPIPS_NET
    try:
        import torch
        import torchvision.models as tvm

        if _LPIPS_NET is None:
            weights = tvm.VGG16_Weights.IMAGENET1K_V1
            path = os.path.join(torch.hub.get_dir(), "checkpoints",
                                os.path.basename(weights.url))
            if not os.path.exists(path):
                raise FileNotFoundError(f"no VGG16 weights at {path}")
            net = tvm.vgg16(weights=None)
            net.load_state_dict(torch.load(path, map_location="cpu"))
            _LPIPS_NET = net.features.eval()
    except Exception as e:  # no weights / no torchvision
        logger.info(f"LPIPS unavailable: {e}")
        return None

    import torch

    layers = {3, 8, 15, 22, 29}

    def feats(x):
        fs = []
        h = x
        for i, m in enumerate(_LPIPS_NET):
            h = m(h)
            if i in layers:
                fs.append(h / (h.norm(dim=1, keepdim=True) + 1e-10))
        return fs

    def prep(img):
        t = torch.from_numpy(np.asarray(img, np.float32) / 255.0 * 2 - 1)
        return t.permute(2, 0, 1)[None]

    with torch.no_grad():
        fa, fb = feats(prep(pred)), feats(prep(gt))
        d = sum(((a - b) ** 2).mean(dim=1, keepdim=True).mean()
                for a, b in zip(fa, fb))
    return float(d)


def evaluate_rendered_images(conf, dpath_rd: Optional[str] = None,
                             dpath_gt: Optional[str] = None,
                             dpath_ma: Optional[str] = None,
                             scale: bool = False) -> Dict[str, float]:
    """Score all rendered views against GT; writes monitor series and
    returns the metric means."""
    scene = str(conf.data_path).rstrip("/").split("/")[-1]
    monitor_path = f"{conf.monitor_base_path}_{scene}"
    dpath_rd = dpath_rd or os.path.join(monitor_path, "rendered")
    dpath_gt = dpath_gt or os.path.join(conf.data_path, "image")
    dpath_ma = dpath_ma or os.path.join(conf.data_path, "mask")

    f_rd = sorted(glob.glob(f"{dpath_rd}/*[0-9].png"))
    f_gt = sorted(glob.glob(f"{dpath_gt}/*"))
    f_ma = sorted(glob.glob(f"{dpath_ma}/*"))
    if not f_rd:
        raise FileNotFoundError(f"No rendered images in {dpath_rd}")

    acc: Dict[str, list] = {k: [] for k in
                            ["psnr", "psnr_mask", "psnr_y", "psnr_y_mask",
                             "ssim", "ssim_mask", "lpips", "lpips_mask"]}
    for frd, fgt, fma in zip(f_rd, f_gt, f_ma):
        rd = np.asarray(read_png(frd), np.float64)[..., :3]
        gt = np.asarray(read_png(fgt), np.float64)[..., :3]
        ma = np.asarray(read_png(fma))
        if ma.ndim == 3:
            ma = ma[..., 0]
        ma = (ma > 127.5)[..., None].astype(np.float64)
        if rd.shape != gt.shape:  # rendered at downsampled res
            step = gt.shape[0] // rd.shape[0]
            gt = gt[::step, ::step][:rd.shape[0], :rd.shape[1]]
            ma = ma[::step, ::step][:rd.shape[0], :rd.shape[1]]

        if scale:
            mgt = (gt * ma).sum() / ma.sum() / 3
            mrd = (rd * ma).sum() / ma.sum() / 3
            rd = np.clip(rd - mrd + mgt, 0, 255)
            rd[rd == 255.0] = 0.0

        acc["psnr"].append(masked_psnr(rd, gt))
        acc["psnr_mask"].append(masked_psnr(rd, gt, ma))
        acc["psnr_y"].append(masked_psnr(rd, gt, luma=True))
        acc["psnr_y_mask"].append(masked_psnr(rd, gt, ma, luma=True))
        acc["ssim"].append(masked_ssim(rd, gt))
        acc["ssim_mask"].append(masked_ssim(rd, gt, ma))
        lp = lpips_vgg(rd, gt)
        if lp is not None:
            acc["lpips"].append(lp)
            acc["lpips_mask"].append(lp)  # spatial masking needs maps; mean

    out = {}
    monitor = Monitor(monitor_path)
    for k, vals in acc.items():
        if not vals:
            continue
        out[k] = float(np.mean(vals))
        MonitorSeries(f"Eval {k}", monitor).add(0, out[k])
    logger.info(f"Image eval: {out}")
    return out
