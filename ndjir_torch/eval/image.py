"""Image-quality metrics: PSNR (+masked, +YCbCr), SSIM (+masked) (the
port's numpy copy of ``ndjir_tpu/eval/image.py``).

PSNR parity with reference python/evaluate_image.py:19-29 (computed on
[0,255] images); SSIM is the standard Wang et al. windowed form (the
reference delegates to scikit-image, scripts/evaluate_rendered_images.py).
"""

from __future__ import annotations

import numpy as np


def psnr(img0: np.ndarray, img1: np.ndarray, mask=None) -> float:
    """img* in [0,1] any layout; computed on the 255-scale
    (reference: evaluate_image.py:19-29)."""
    a = np.asarray(img0, np.float64) * 255.0
    b = np.asarray(img1, np.float64) * 255.0
    if mask is not None:
        m = np.broadcast_to(np.asarray(mask, bool), a.shape)
        mse = np.mean((a[m] - b[m]) ** 2)
    else:
        mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(20 * np.log10(255.0 / np.sqrt(mse)))


def rgb_to_ycbcr(img: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 full-range conversion; img (..., 3) in [0,1]."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 0.5
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 0.5
    return np.stack([y, cb, cr], axis=-1)


def _gaussian_kernel(size=11, sigma=1.5):
    ax = np.arange(size) - size // 2
    k = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = k / k.sum()
    return np.outer(k, k)


def ssim_map(img0: np.ndarray, img1: np.ndarray, data_range: float = 1.0,
             mode: str = "valid") -> np.ndarray:
    """Per-pixel SSIM map, 11x11 gaussian window (Wang et al.)."""
    from scipy.signal import fftconvolve

    a = np.asarray(img0, np.float64)
    b = np.asarray(img1, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    win = _gaussian_kernel()

    def filt(x):
        return np.stack([fftconvolve(x[..., c], win, mode=mode)
                         for c in range(x.shape[-1])], axis=-1)

    mu_a, mu_b = filt(a), filt(b)
    mu_a2, mu_b2, mu_ab = mu_a ** 2, mu_b ** 2, mu_a * mu_b
    sa = filt(a * a) - mu_a2
    sb = filt(b * b) - mu_b2
    sab = filt(a * b) - mu_ab
    return ((2 * mu_ab + C1) * (2 * sab + C2)) / \
        ((mu_a2 + mu_b2 + C1) * (sa + sb + C2))


def ssim(img0: np.ndarray, img1: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM over channels (valid padding)."""
    return float(np.mean(ssim_map(img0, img1, data_range, mode="valid")))


def ssim_masked(img0: np.ndarray, img1: np.ndarray, mask: np.ndarray,
                data_range: float = 1.0) -> float:
    """Mask-weighted mean SSIM: the prediction is composited onto the GT
    background inside the mask, and the per-window SSIM map is averaged with
    the gaussian-filtered mask as weights, so windows that do not overlap
    the mask contribute nothing (a plain mean over the composited image
    scores every all-background window exactly 1.0).

    img* (H, W, C) in [0, 1]; mask (H, W) or (H, W, 1) in {0, 1}.
    """
    from scipy.signal import fftconvolve

    m = np.asarray(mask, np.float64)
    if m.ndim == 3:
        m = m[..., 0]
    m3 = (m > 0.5)[..., None]
    comp = np.where(m3, np.asarray(img0, np.float64),
                    np.asarray(img1, np.float64))
    smap = ssim_map(comp, img1, data_range, mode="valid")   # (h, w, C)
    w = fftconvolve(m, _gaussian_kernel(), mode="valid")    # window overlap
    w = np.clip(w, 0.0, None)[..., None]
    denom = w.sum() * smap.shape[-1]
    if denom <= 0:
        return float("nan")
    return float((smap * w).sum() / denom)
